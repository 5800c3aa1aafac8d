#!/usr/bin/env python3
"""Smoke run of pg_embedding_tpu_torch on one NVIDIA GPU.

  python3 chip_smoke.py [--n ROWS] [--queries B]

(``--rank R --world W --port P --workdir DIR`` runs one rank of phase 11;
the phase starts its ranks itself.)

Phases, each printing one line (no failure is caught; any failed check
exits non-zero):
  1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
  2. build the CUDA kernels from the repository's sources;
  3. the kernel: its compiler report (registers, spills) and the HMMA
     instructions of each of its 28 row sweep instances and the PQ
     kernel's (cuobjdump -sass: TF32 in every row instance but the twelve
     Manhattan ones, which run none; bf16 in the PQ sweep; the exact
     route's eight float32 / bf16 ones must report the registers and
     spills they had before the int8 instance, SWEEP_PTXAS; the four wide
     float32 / bf16 ones, the four int8 ones, the twelve Manhattan ones
     and the PQ sweeps and select are printed; the Manhattan ones also
     their FADDs and 16-byte shared loads); against its plain torch
     twin: L2 and cosine, and Manhattan (the exact route's k = 10, the
     build's pool of 256 over the int8 shadow, QT = 16, pages, bf16 rows
     aligned and not), D in {30, 100, 128, 960}, k_run from 1
     to 1024 with each query tile's edges (64 / 65, 256 / 257), B not a
     multiple of the tile, with and without n_valid < N and tombstones, one
     k > n_valid case, up to 1M rows x 1024 queries, for a float32 corpus,
     a bfloat16 one (aligned and an unaligned view) and an int8 shadow
     (the build's 1M x 256-row pool of 256 and a 64-d pool of 130 with
     tombstones through the Hopper instance bruteforce_topk_q8_wgmma;
     bruteforce_topk_q8 at D = 100 / 960, QT = 16, pages, a view one
     byte in: each case's line names the instance it took); k_run from
     64 to 256 over
     float32 / bf16 rows runs the wide instances (bruteforce_topk_wide /
     _bf16_wide, with exact mode's 1M x 256-row pool of 130 and the exact
     route's k = 100 at B = 1024);
     k_run 1502, 2100 and 1500 in
     pages (bruteforce_topk_paged) against the plain twin's one
     list; at 1M x 128-d,
     B=1024, k_run=12 (CUDA events) each instantiation's time, its bound
     (products_s: 3 TF32 passes for float32 rows; for bf16 values the
     lesser of 2 TF32 passes and 3 bf16 ones) and share
     of it, the plain twin's time, and library_ms: torch.addmm of the L2
     scores in full float32 plus torch.topk (a yardstick the port never
     calls);
  4. the main path at SIFT1M's shape (1,000,000 x 128-d, BASELINE.md
     config 1, bench.py's clustered recipe as utils/io.synthetic_clustered
     draws it, seed 12345): HnswIndex.build,
     graph invariants, search() in auto mode through the kernel, exact and
     graph QPS, recall@10 of the graph route (>= 0.90 at T=8, printed
     beside EARLIER_RECALL; T=4's is printed), deletes never surfacing;
     every build batch past the first one bruteforce_topk_q8_wgmma launch
     (the build's candidate sweep) and no torch-op sweep on the card, every
     batch one connect_batch launch (the wiring: back-links and their
     re-prunes) and no plain wiring on the card (PLAIN_CONNECTS_ON_CARD),
     prune_scan only at the insert's width; before
     it, a small build that must match the same build on the CPU, and
     exact-mode builds of 4,000 rows (float32 and bf16 storage: one launch
     of the wide instance a batch past the first, link rows >= 95% equal
     to the CPU's) and an exact8 build of 4,000 rows at ef_construction
     160 (a pool of 320, which the rule keeps on bruteforce_topk_q8: one
     launch a batch past the first, the kernels line's launches of it);
 4b. right after the main path, on its index: the walk and prune kernels
     (ops/cuda_graph) against their plain twins.  beam_walk at ef=64, T=4
     and T=8 on the 1,024 queries against core/search._search_batch called
     directly on the card: recall@10 (vs the exact route over the same
     rows) within 0.002 of the twin's, ids equal on >= 98% of queries (the
     queries that differ are printed: float32 sums in another order flip
     near-ties mid-walk), mean hops and dist_evals within 1%; on an
     integer-coordinate index (3,000 x 32, integers in [-8, 8], every L2
     and Manhattan distance exact in float32) bit-equal at T in {1, 4, 8}
     and (ef, cand_cap) in {(16, 16), (64, 64), (64, 128), (128, 64)},
     and in every other row source (bf16 rows; int8 rows and int8 records
     at power-of-two scales; f32 and bf16 records; the int8 and bf16 rows
     and records staged in shared memory, and read from the rows or
     records at T = 256, (256, 256), where they do not fit; the f32
     records through their ring at every table shape, read from the
     records in the wide instances; PQ records
     through an
     integer codebook, with and without OPQ's signed-permutation rotation,
     read through the query's distance table, at G 8 and also at G 4, 16
     and 32 at T=8 (64, 128) and T=4 (5120, 5120))
     and the bitmap and hash visited sets at T in {1, 4, 8}, (ef,
     cand_cap) in {(16, 16), (64, 128)} (each set in the block's shared
     memory, where the placement rule keeps it, and forced into device
     memory), and queues wider than the 320
     of the kernel's table instances (the wide instances: (5120, 5120) for
     every row source and set, (4097, 64), (64, 8191), (8191, 8191) and
     (16384, 16384), whose queues leave shared memory, for float32 rows
     under every set); the ptxas report of the main path's two walk
     instances must equal WALK_PTXAS;
     prune_scan bit-equal to core/build._prune_scan_plain on the candidate
     sets of one real 256-row insert batch (an add() to the index: its
     insert prune, C = 128, nn = 16; its re-prunes run inside
     connect_batch), with the main path's build's prune_scan launches
     counted at each width (by the wrapper, ops/cuda_graph.PRUNE_SHAPES; 0
     at the re-prune's, C = maxM + 1 = 33).  Times of each
     kernel a call (CUDA events around one call, median of 5, as for each
     twin: the JSON's "ms") and on the card (20 calls
     captured in a CUDA graph, replayed between CUDA events: the host's
     launch overhead is not timed; for the walk it includes the wrapper's
     entry-distance op) at each shape beside the kernel's bound (the bytes
     it must read, from the kernel's own hop and evaluation counts, and the
     pairs the scan tests) and the share of it reached; torch.profiler
     (CPU and CUDA activity) over one search(mode="graph") at T=4 and T=8
     and over that insert: wall time, device-busy share and device
     operations; then each kernel's phases at those shapes from a
     clock64()-stamped build of the same sources
     (pg_embedding_tpu_torch/graph_probe.py, built beside the port's
     library; never launched by the main path), and ptxas's registers
     and spills of every walk and scan instance in phase 3's report;
     the build's candidate sweep on that add()'s batch (captured by
     wrapping core/build.sweep_pool): bruteforce_topk_q8_wgmma's pool
     against its plain twin (distances within phase 9's cancellation
     tolerance, ids except float64 near-ties), the final cand_cap after the
     exact rerank equal on >= 99.9% of rows, its time a call and on the
     card beside its bound (products_s), the mma.sync bruteforce_topk_q8
     forced on the same batch (held to the twin the same way), the twin,
     the torch-op loop it replaced (loop_pool) and torch.matmul +
     torch.topk, which the kernel must beat on the card; the same for
     exact mode (bruteforce_topk_wide
     over float32 rows and bruteforce_topk_bf16_wide over their bf16
     values, pool cand_cap + 2, beside addmm + topk) and for Manhattan over
     the shadow (bruteforce_topk_q8_l1 beside its twin, the torch-op loop
     and torch.cdist(p=1) + topk, its bound 2 B N D float32 operations
     and, beside it, its FADD ceiling: 2 B N D FADDs at the SMs' 128
     lanes and the card's max SM clock, l1_ceiling_ms);
     the wiring of that
     add()'s batch (captured by wrapping core/build._connect_batch):
     connect_batch against its plain twin (core/build._connect_sorted_plain:
     the forward rows, then _replay_chains) on copies of the links (every
     member's row and every target that only appends equal, >= 99% of the
     re-pruned ones; the share that differs is its max_abs_err), its
     launch shape, its counters (chains, re-prunes), its time a call and on
     the card beside its bound (connect_bound_ms) and the twin's, and
     bit-equal to the twin on integer rows for every metric, float32 /
     bf16 rows and each tier (the warp tier to its widest set, C = 64, and
     at rows of no whole 16-byte chunks; the block tier from C = 65; masks
     only; masks in device memory: connect_integer_cases); eight more
     add()s, each
     broken down on the host clock (staging, the sweep's launch, the
     prune, the wiring, the closing wait: median / min / max), the host
     syncs inside them counted (none allowed), re-prunes a batch from the
     kernel's counters, peak device memory, and one through loop_pool with
     its peak; then a 200,000-row build through the kernels (its sweep
     on bruteforce_topk_q8_wgmma by the rule) and again with core/build's
     sweep swapped for loop_pool and its wiring for _connect_batch_plain,
     and once more with the route forced to the mma.sync
     bruteforce_topk_q8: link rows >= 99.9% identical, graph recall@10
     within 0.002 (against the mma.sync build at T=4 and T=8);
  5. on the same index: tune_exact8_chunk (its cache in a temp dir, not
     saved): the exact8 sweep's ms per 256-row insert batch at chunks of
     262,144 / 524,288 / 1,048,576 / 2,097,152 rows (one kernel launch
     that takes no chunk), and the chunk chosen; the serving variants at
     T=8 (quantized, packed int8 / bf16 / float32 records; QPS and
     recall@10; float32 records give
     the plain walk's ids and order), the bitmap (the dense walk's ids)
     and hash visited sets; each variant's walk kernel against its twin on
     the card at 1M on every query (variant_vs_twin: recall within 0.002,
     ids on >= 98% of queries, hops and dist_evals within 1%) and timed
     beside its bound (the int8 rows and int8 / bf16 / f32 records walks
     at T=8 and at the API's default T=4, each also printing its
     placement, staged bytes, instance's ptxas registers and spills and
     the blocks an SM of each placement, the runtime's occupancy, which
     must bear out the placement rule: staging_placement; the f32 records
     walks also their ring's rows K, the blocks an SM at K + 1 (one fewer:
     K is the most), the ring instance's launches over their API path
     (ops/cuda_graph.RING_WALKS) and the twin's ids, hops and dist_evals
     on every query; the bitmap and hash sets at
     T=8 and T=4, each printing where its set lives, shared or device
     memory, the blocks an SM with it and without it, which must bear out
     that rule too, the wrapper's fill of a device set timed on its own
     and the bound without the set's words: visited_placement), each
     variant's launches counted
     from 0 over its own API calls; a filtered graph search that widens
     from ef_search 40 to
     5120: 8 kernel launches, the last four (ef 640 to 5120) through the
     wide instances, no plain walk, only allowed rows, >= 0.9 of them the
     masked exact route's; each walk of that ladder timed on the card (64
     queries); its last walk, unfiltered, against the twin as each variant
     is (64 queries) and timed beside its bound, and timed at B = 1024;
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
     ef=64), its walk kernel against its twin; the card's pq_encode against the CPU's on 100k rows (>= 99.9%
     equal codes, every other one a float64 near-tie) and the card's PQ
     walk against the CPU's on the same state;
  7. last on that index, downcast_corpus("bfloat16") and search() through
     the kernel's bf16 instantiation, held on every query to a float64
     oracle over the stored bf16 rows: recall@10 >= 0.99, and every row it
     returns within the kernel check's near-tie tolerance of the oracle's
     10th distance.  Its recall@10 against the float32 route is printed,
     not held: bf16 rounding of the rows reorders near-ties at rank 10.
     Then the graph route over the bf16 rows at T=8 and at the API's
     T=4, and that walk kernel against its twin at each (with its
     placement: staging_placement).
     The PQ shadows must be the same tensors after the cast, and the PQ
     walk must still answer;
  8. PQ serving on a second 1M x 128-d index of benchmarks/bench_pq.py's
     recipe (50,000 centres), where the JAX package measured it: the PQ
     walk at G=16, OPQ G=32 (its walk kernel against its twin) and G=32
     (G=32 held within 0.03 of the plain walk's recall@10, the others
     printed); tune_sweep_pool(0.95) on 256
     queries, then search(mode="sweep_pq") on all (recall@10 >= 0.95,
     distances equal to a float64 recompute at rtol 1e-5, QPS), every
     count set to 0 before the tuner: only bruteforce_topk_pq launches; its
     pool (ops/pq_sweep._pq_pool: one bruteforce_topk_pq call, the codes
     decoded through the codebook in the kernel, csrc/pq_topk.cu) against
     its twin _pq_pool_plain on all queries (ids on >= 99.9% of slots,
     every other a float64 near-tie; distances rtol 1e-5), timed a call,
     on the card, beside its bound, the twin and library_ms (pq_decode +
     torch.matmul + torch.topk), the same at pools 32, 256, 512 and 1024,
     and its Manhattan sum against the twin on 128 queries (the same bar);
     save -> load (the same codebook bytes, walk and sweep labels);
  8b. (run after phase 7, before phase 9) a Manhattan index of config 1's
     shape on the main path's rows (m=16, efc=64, exact8), every count set
     to 0 before its build: one bruteforce_topk_q8_l1 launch a batch past
     the first and no torch-op sweep; its exact route (one
     bruteforce_topk_l1 launch) against a float64 oracle over every row
     and against its twin on all queries; its graph route's recall@10
     against its exact route, within 0.002 of its value before the
     register-tile redesign (EARLIER_L1_RECALL, at 1M); its build's
     seconds beside the main path's L2 build's; the exact route at 1M,
     B=1024, k=10 over float32 rows and their bf16 values
     (bruteforce_topk_bf16_l1 through fused_exact_search), each timed
     beside its twin, its bound, its FADD ceiling and torch.cdist(p=1) +
     topk;
  9. the sharded index (parallel/sharded.ShardedHnswIndex, 4 shards on the
     card, batches of 256 rows a shard as the single index takes them) on
     the main index's rows and queries, built from scratch: build
     seconds, exact and graph QPS and recall@10 beside the single index's;
     search() in auto mode launches the kernel exactly once per shard and
     its labels equal the single index's on every query except float64
     near-ties; graph recall@10 >= 0.90 against the exact route; 1,000
     deleted labels never surface; save(per_shard=True) -> load gives the
     same labels on both routes (it runs before phase 8's index is built);
     last, the kernel against its plain twin on every shard's own view of
     the stacked rows, with that shard's count and tombstones (distances
     within 32 float32 roundings of the raw score: these rows' norms dwarf
     their distances), and the per-shard exact call against a float64
     oracle at rtol 1e-5 (phase 3 also holds a random case of a shard's
     shape at the plain 1e-5);
 11. right after phase 9, two ranks of the sharded index on the one card
     (torch.distributed over gloo, each rank holding 2 of the 4 shards,
     started by the phase as processes of this script, killed at a time
     limit): (a) phase 9's per-shard snapshot of the 1M index loaded by
     both, each reading only its own shards' rows: exact and graph (T=8,
     ef=64) labels on all queries equal phase 9's except slots explained
     as float64 near-ties (printed), the kernel launched twice a rank per
     exact call; (b) 1,000 more deletes never surface, save(per_shard=True)
     from the owners loads back with the same labels; (c) the first
     200,000 rows built across the ranks at batches of 256 against a
     single-process S=4 build of them: link rows >= 99.9% identical, labels
     equal on both routes except explained near-ties; per-rank load / save
     / build seconds, QPS and launches printed;
 10. VectorTable on the card: the knn.sql replay (3-d), then a 20,000 x
     128-d table with <->, <=> and <~> indexes, each built with one kernel
     launch a batch past the first (bruteforce_topk_q8_wgmma, and _q8_l1
     for <~>) and no torch-op sweep: the seq scan (order_by(use_index=False),
     through the exact entry) against a float64 oracle, and the pull scan
     against order_by through the index.
Phases are timed with utils/profiling's Timer (synchronising the card).
The last three lines are the card's nvidia-smi line, a JSON line of the
kernels ("launches" from the main path of phase 4, the wide instances'
from their own path, the exact-mode builds, the Manhattan instances' from
phase 8b's index and the PQ kernel's from phase 8's sweep_pq, each counted
from 0 just before it; the build sweep instances' timings (Manhattan's
exact8 one too) are phase 4b's on the add()'s 1M batch, with "loop_ms"
(the torch-op loop each replaced), the Manhattan exact route's phase 8b's;
the PQ kernel's "pools" and "manhattan" phase 8's; the Manhattan
instances' also "ceiling_ms" (l1_ceiling_ms); for prune_scan also
"insert_launches" and "reprune_launches", the build's launches at the
insert's width and at the re-prune's (0: the re-prunes run inside
connect_batch); for connect_batch its counters on the add()'s batch,
"rows_equal" and "reprune_rows_equal" to the twin there (its
"max_abs_err" is the share of re-pruned targets whose row differs) and
"add", the eight add()s' breakdown; "ms" is a call's time between
CUDA events, host share included, for every kernel, and
the walk and the scan also give "device_ms", the card's time from the CUDA
graph; the walk's "variants": each variant's launches over its own API
path (counted from 0 just before it) and variant_vs_twin's numbers (the
int8 / bf16 records walks' and the visited sets' also at T=4, keyed "...
T=4", and each with its "placement" and "blocks_per_sm", the runtime's
occupancy; the sets' also "fill_ms", the wrapper's fill of a device set,
null where the set is shared, "bound_without_set_ms" and
"bound_with_set_ms": a shared set's "bound_ms" is the bound without the
set's words, a device set's the bound with them), and
its "wide_queues": variant_vs_twin's numbers at ef 5120, the widening
search's launches of the wide instances ("launches", 1) and theirs by phase
("launches_by_phase"), the ladder's card times and the B = 1024 time and
bound; "sharded_launches" from
phase 9, "multiprocess_launches" summed over phase 11's ranks, each
counted from zero; the main path, phase 9 and phase 11 must each launch
beam_walk, prune_scan and connect_batch, every walk variant must reach the
kernel, and no walk of phases 4-11 may run the plain twin on the card, nor
any candidate sweep the torch-op loop, nor any wiring or PQ pool the plain
twin (phase 10 included, its Manhattan index too): only the smoke's own
twin calls do, under own_twin_calls), and {"ok": true,
"device": {...}}.

Needs a CUDA device and nvcc; without a device it exits non-zero before
printing any result.
"""

import argparse
import concurrent.futures
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
# the integer walk operands the card tests build too (tests/walk_operands.py)
sys.path.insert(1, os.path.join(REPO, "tests"))

L2, COSINE, MANHATTAN = 0, 1, 2
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
# the API's default search_expand_width (HnswIndex): the int8 rows and the
# int8, bf16 and float32 records walks (serving_variants' names) are held
# to their twin at this T too (and the bf16 rows walk, bf16_phase)
API_T = 4
RECORDS_AT_API_T = ("quantized", "packed int8", "packed bfloat16",
                    "packed float32")
SHARDS = 4
# rows a shard takes per insert batch: the single index's batch, not the
# sharded default of 128, whose 7,812 host-bound batches cost the smoke
# 190-270 s
SHARD_BATCH = 256
# float32 roundings of the raw L2 score within which the kernel and its plain
# twin must agree on the clustered rows (see shard_kernel_vs_plain)
SHARD_UNITS = 32
# phase 11: ranks on the one card, the rows of its build, its time limit
MP_WORLD = 2
MP_BUILD_ROWS = 200_000
MP_TIMEOUT = 420
LAUNCH_NAMES = ("bruteforce_topk", "bruteforce_topk_bf16",
                "bruteforce_topk_wgmma", "bruteforce_topk_bf16_wgmma",
                "bruteforce_topk_q8", "bruteforce_topk_q8_wgmma",
                "bruteforce_topk_wide",
                "bruteforce_topk_bf16_wide", "bruteforce_topk_l1",
                "bruteforce_topk_bf16_l1", "bruteforce_topk_q8_l1",
                "bruteforce_topk_pq", "beam_walk", "prune_scan",
                "connect_batch")
# the Manhattan instances (the CUDA cores' sum, no tensor-core product)
L1_SWEEPS = ("bruteforce_topk_l1", "bruteforce_topk_bf16_l1",
             "bruteforce_topk_q8_l1")
# phase 8: the PQ pools timed beside the twin and the library call (the
# tuner's choices reach 1024)
PQ_POOLS = (32, 256, 512, 1024)
# the sweep's instances of the build's pools (exact8: the Hopper one the
# rule takes and the mma.sync one, forced beside it; exact mode)
BUILD_SWEEPS = ("bruteforce_topk_q8_wgmma", "bruteforce_topk_q8",
                "bruteforce_topk_wide", "bruteforce_topk_bf16_wide")
# phase 4b: the walk kernel's beam and widths at 1M
WALK_EF = 64
WALK_TS = (4, 8)
# NVIDIA's H100 SXM data sheet, dense: TF32 and bf16 tensor cores, float32
# outside them, HBM3
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# the walk's row sources and visited sets beyond float32 rows under the
# dense dedupe (ops/cuda_graph.walk_variant's names)
WALK_SOURCES = ("rows bf16", "rows int8", "records f32", "records bf16",
                "records int8", "records pq", "records pq rotated")
WALK_VISITED = {"bitmap": 0, "hash": 8192}
# queues past the 320 of the walk's table instances (the wide instances):
# the API's widening from ef_search = 40 lands on 5120, and reaches 8,191;
# past ~13,850 the queues leave shared memory; the integer index's cases
WIDE_QUEUES = ((5120, 5120), (4097, 64), (64, 8191), (8191, 8191),
               (16384, 16384))
# the PQ walk's integer cases beside G = 8, (D, G): D = 32 at G = 2 (16
# elements a group, each record's codes copied byte by byte), 4, 16 and 32
# (2 and 1 element: the table's build reads the codebook an element at a
# time), and the index's first 24 dims at G = 3; in a table instance and
# the wide one
PQ_INTEGER_GROUPS = ((32, 2), (32, 4), (32, 16), (32, 32), (24, 3))
PQ_INTEGER_SHAPES = ((8, 64, 128), (4, 5120, 5120))
# the int8 / bf16 records and rows sources, staged in shared memory at
# every integer shape but (T, ef, cand_cap) = RECORDS_UNSTAGED, whose T =
# 256 popped rows' records or slots' rows do not fit a block beside its
# queues and tables
STAGED_SOURCES = ("records int8", "records bf16", "rows int8", "rows bf16")
RECORDS_UNSTAGED = (256, 256, 256)
# ptxas's report of the eight float32 / bf16 sweep instances as they were
# built before the int8 instance (no stack, no spills): it leaves their code
# as it was; and of the three Hopper instances as they were first built
SWEEP_PTXAS = {
    f"sweep_kernel<QT={qt}, {res} queries, {elem}>": (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"Used {regs} registers, used 1 barriers")
    for (qt, res, elem), regs in {
        (16, "streamed", "float"): 80, (16, "streamed", "bf16"): 88,
        (16, "resident", "float"): 94, (16, "resident", "bf16"): 92,
        (64, "streamed", "float"): 115, (64, "streamed", "bf16"): 117,
        (64, "resident", "float"): 126, (64, "resident", "bf16"): 119,
    }.items()}
SWEEP_PTXAS.update({
    f"sweep_wgmma_kernel<{elem}>": (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"Used {regs} registers, used 16 barriers")
    for elem, regs in (("float", 117), ("bf16", 96))})
SWEEP_PTXAS["sweep_q8_wgmma_kernel<int8>"] = (
    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "Used 118 registers, used 3 barriers")
# ptxas's report of the main path's walk instances (float32 rows, dense
# dedupe; T = 4: 128 threads, T = 8: 256) before the wide instances'
# redesign: it leaves their code as it was
WALK_PTXAS = {
    "beam_walk_kernel<float32 rows, dense, 128 threads>": (
        "40 bytes stack frame, 68 bytes spill stores, 108 bytes spill loads",
        "Used 96 registers, used 1 barriers, 40 bytes cumulative stack size"),
    "beam_walk_kernel<float32 rows, dense, 256 threads>": (
        "176 bytes stack frame, 632 bytes spill stores, 1100 bytes spill "
        "loads",
        "Used 64 registers, used 1 barriers, 176 bytes cumulative stack "
        "size"),
}
# ptxas's report of every walk instance by name (compiler_report's), read
# by variant_vs_twin for the records walks' instances
WALK_REPORTS = {}
# the walks of the API's widening from ef_search 40 (cand_cap = ef): those
# past 320 (640 to 5120) run the wide instances
WIDENING_EFS = (40, 80, 160, 320, 640, 1280, 2560, 5120)
# the mma.sync instances' time at 1M x 128-d, B=1024, k_run=12 when their
# code last changed (PERF.md, Findings): the exact route's kernels before
# the Hopper instances took that shape
EARLIER_MS = {"bruteforce_topk": 6.604, "bruteforce_topk_bf16": 5.287}
# the Hopper instance of each row type and the mma.sync one it replaced on
# the exact route's short lists
HOPPER_OF = {"bruteforce_topk_wgmma": "bruteforce_topk",
             "bruteforce_topk_bf16_wgmma": "bruteforce_topk_bf16"}
# the build's sweep on the card (phase 4b) before the wide selection:
# bruteforce_topk_q8's and exact mode's; and exact8's mma.sync instance
# before the Hopper one took it (PERF.md, Findings)
EARLIER_SWEEP_MS = {"exact8": 6.746, "exact": 5.975}
EARLIER_Q8_MS = 3.125
# phase 4: the exact8 build whose pool (2 x 160) the rule keeps on the
# mma.sync int8 instance
Q8_MMA_EFC = 160
# phase 4b: the rows of the build built twice (the sweep kernel, then the
# torch-op loop in its place); the graph recall@10 at 1M, T=8, of the graph
# the torch-op sweep built (PERF.md, Findings)
TWIN_BUILD_ROWS = 200_000
EARLIER_RECALL = 0.9208
# phase 8b: the Manhattan index's graph recall@10 at T=8 before the
# register-tile redesign of its sweep (PR 16's run); every score is the
# same since, so the graph and its recall are too
EARLIER_L1_RECALL = 0.9367


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
    if metric == MANHATTAN:
        return (p - q).abs().sum(-1)
    dot = (p * q).sum(-1)
    return 1.0 - dot / torch.sqrt((p * p).sum(-1) * (q * q).sum(-1))


def compare(torch, got, want, qs, pts, metric, n_valid, dead,
            cancel_units=0):
    """Kernel vs plain: distances to rtol 1e-5; where ids differ, the
    kernel's row must be a near-tie: its float64 distance within 1e-5
    relative of the plain's distance at that rank.  ``cancel_units`` (L2
    only) widens both by that many float32 roundings of the sweep's raw
    score |q|^2 - 2 q.p + |p|^2, seen through the square root:
    units * 2^-23 * (|q|^2 + |p|^2) / (2 d); it is for rows whose norms
    dwarf their distances (the exact route reranks such scores).  Returns
    (max abs distance error, mismatched ids)."""
    dk, ik = got
    dp, ip = want
    check(torch.equal(torch.isinf(dk), torch.isinf(dp)), "inf pattern")
    fin = torch.isfinite(dp)
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    tol = 1e-5 * dp.double().abs() + 1e-6
    if cancel_units:
        norms = ((qs.double() ** 2).sum(1, keepdim=True)
                 + (pts[ip.clamp(min=0).long()].double() ** 2).sum(-1))
        tol = tol + (cancel_units * 2.0 ** -23 * norms
                     / (2 * dp.double()).clamp(min=1e-6))
    check(bool(((dk[fin] - dp[fin]).abs() <= tol[fin]).all()),
          f"distances differ by up to {err}")
    ok_ids = ik[ik >= 0]
    check(bool((ok_ids < n_valid).all()), "id past n_valid")
    if dead is not None:
        check(not bool(dead[ok_ids.long()].any()), "tombstone returned")
    diff = ik != ip
    if diff.any():
        d64 = true_dist(torch, qs, pts, ik, metric)[diff]
        check(bool(((d64 - dp[diff].double()).abs() <= tol[diff]).all()),
              "an id differs at a rank that is not a near-tie")
    return err, int(diff.sum())


def f64_errors(torch, got, want, qs, pts, metric):
    """Kernel and plain against float64 over the rows they returned: the
    mean and largest |d - d64| of each, and the largest kernel-plain
    difference over compare's tolerance (1e-5 d + 1e-6; past 1 it
    fails).  Returns a phrase for the log."""
    out = []
    for d, ids in (got, want):
        fin = torch.isfinite(d)
        e = (d.double() - true_dist(torch, qs, pts, ids, metric))[fin].abs()
        out.append(f"mean {float(e.mean()):.3g}, largest {float(e.max()):.3g}")
    fin = torch.isfinite(want[0])
    ratio = ((got[0] - want[0]).abs() / (1e-5 * want[0].double().abs()
                                          + 1e-6))[fin].max()
    return (f"vs float64 kernel {out[0]}, plain {out[1]}; largest "
            f"difference {float(ratio):.3f} of the tolerance")


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
        # one shard of the sharded phase: its capacity, its rows, tombstones
        (L2, 253_952, 128, 1024, 12, 250_000 / 253_952, True, f32),
        (COSINE, 50_000, 128, 256, 1000, 1.0, True, f32),
        (L2, 50_000, 100, 128, 1024, 0.7, False, f32),
        (L2, 20_000, 128, 1024, 100, 0.004, True, f32),   # k > n_valid
        # the Hopper instances' edges: D = 32 at the rule's largest
        # k_run, D % 32 != 0 with B not a multiple of 64
        (L2, 300_000, 32, 1000, 63, 0.9, True, bf16),
        (COSINE, 200_000, 96, 65, 33, 1.0, False, f32),
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
        # the int8 shadow (quantize_rows of the rows): the build's sweep at
        # 1M (B = 256, pool 2 cand_cap = 256) and a 64-d pool of 130 with
        # n_valid < N and tombstones (the Hopper instance); D % 16 != 0,
        # QT = 16, a pool past 256, pages and a view that starts one byte
        # in (bruteforce_topk_q8)
        (L2, 1_000_000, 128, 256, 256, 1.0, False, "q8"),
        (COSINE, 300_000, 64, 65, 130, 0.9, True, "q8"),
        (COSINE, 300_000, 100, 65, 130, 0.9, True, "q8"),
        (L2, 100_000, 960, 17, 1024, 1.0, False, "q8"),
        (COSINE, 200_000, 128, 63, 257, 0.8, True, "q8"),
        (L2, 200_000, 128, 64, 1500, 0.9, False, "q8"),
        (L2, 100_000, 128, 256, 256, 1.0, True, "q8 unaligned"),
        # the float32 / bf16 wide instances (k_run from WIDE_MIN_K to 256;
        # the cases above at k_run 64-256 run them too): exact mode's build
        # sweep at 1M (B = 256, pool cand_cap + 2 = 130), the exact route's
        # k = 100 at B = 1024 with n_valid < N and tombstones, D % 4 != 0
        (L2, 1_000_000, 128, 256, 130, 1.0, False, f32),
        (L2, 300_000, 128, 1024, 102, 0.9, True, f32),
        (COSINE, 100_000, 30, 17, 64, 0.8, True, f32),
        (L2, 1_000_000, 128, 256, 130, 1.0, False, bf16),
        (COSINE, 100_000, 960, 63, 256, 1.0, True, bf16),
        # Manhattan's instances (the CUDA cores' sum): the exact route's
        # k = 10 at B = 1024, the build's pool of 256 over the int8
        # shadow, QT = 16, pages, D % 4 != 0, tombstones
        (MANHATTAN, 300_000, 128, 1024, 10, 0.9, True, f32),
        (MANHATTAN, 200_000, 100, 300, 257, 1.0, False, f32),
        (MANHATTAN, 100_000, 30, 65, 1500, 0.8, True, f32),
        (MANHATTAN, 300_000, 128, 1024, 10, 1.0, True, bf16),
        (MANHATTAN, 100_000, 960, 17, 130, 0.9, False, "bf16 unaligned"),
        (MANHATTAN, 300_000, 128, 256, 256, 1.0, False, "q8"),
        (MANHATTAN, 100_000, 100, 63, 1024, 0.9, True, "q8"),
    ]
    from pg_embedding_tpu_torch.core.build import quantize_rows
    i8 = torch.int8
    max_err = dict.fromkeys(cb.LAUNCHES, 0.0)
    for metric, n, d, b, k_run, frac, tomb, dtype in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + n + d + k_run)
        unaligned = dtype in ("bf16 unaligned", "q8 unaligned")
        if dtype == "bf16 unaligned":   # rows start 2 bytes in
            dtype = bf16
            pts = torch.randn((n + 1, d), generator=g, device=dev).to(dtype)
            pts = pts.view(-1)[1:1 + n * d].view(n, d)
        elif dtype in ("q8", "q8 unaligned"):
            qv, qsc = quantize_rows(torch.randn((n + 1, d), generator=g,
                                                device=dev))
            if unaligned:               # rows start 1 byte in
                qv = qv.view(-1)[1:1 + n * d].view(n, d)
            corpus, dtype = (qv[:n], qsc[:n]), i8
            pts = cb.dequantize_rows(*corpus).float()
        else:
            pts = torch.randn((n, d), generator=g, device=dev).to(dtype)
        if dtype is not i8:
            corpus = pts
        qs = torch.randn((b, d), generator=g, device=dev)
        n_valid = int(n * frac)
        dead = (torch.rand(n, generator=g, device=dev) < 0.05) if tomb else None
        got = cb.bruteforce_topk_paged(qs, corpus, k_run, metric, n_valid,
                                       dead)
        want = cb._bruteforce_topk_plain(qs, corpus, k_run, metric, n_valid,
                                         dead)
        torch.cuda.synchronize()
        err, n_diff = compare(torch, got, want, qs, pts, metric, n_valid,
                              dead)
        live = n_valid - (0 if dead is None else int(dead[:n_valid].sum()))
        if k_run > live:
            check(bool((got[1][:, live:] == -1).all()), "k > n_valid padding")
        name = cb.launch_instance(qs, corpus, k_run, metric)[0]
        max_err[name] = max(max_err[name], err)
        log(f"kernel vs plain: {name}"
            f"{' (unaligned view)' if unaligned else ''} "
            f"{('l2', 'cosine', 'manhattan')[metric]} "
            f"N={n} D={d} B={b} k_run={k_run} n_valid={n_valid} "
            f"tombstones={tomb}: max_abs_err={err:.3g} near-tie id "
            f"swaps={n_diff}")
        del pts, qs, got, want, corpus

    g = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.randn((1_000_000, 128), generator=g, device=dev)
    qs = torch.randn((1024, 128), generator=g, device=dev)
    (n, d), b, k_run = pts.shape, qs.shape[0], K + 2
    out = {}
    from pg_embedding_tpu_torch.graph_probe import device_ms
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for corpus in (pts, pts.to(bf16)):
        plain_ms = time_ms(torch, lambda: cb._bruteforce_topk_plain(
            qs, corpus, k_run, L2, n), 3)
        lib_ms = library_ms(torch, qs, corpus.float(), k_run)
        bound, bound_by = bound_ms(b, n, d, corpus.element_size(), k_run)
        name, wgmma = cb.launch_instance(qs, corpus, k_run, L2)
        check(wgmma, f"{name}: the main path's shape left the Hopper "
              f"instances")
        # the Hopper instance the wrapper takes, then the mma.sync one it
        # took before, forced at the same shape, in turns
        runs = {name: lambda: cb.bruteforce_topk(qs, corpus, k_run, L2, n),
                HOPPER_OF[name]: lambda: cb._launch(
                    qs, corpus.dtype, (corpus.data_ptr(),),
                    corpus.element_size(), n, n, k_run, L2, None, None,
                    False)}
        got = {r: [] for r in runs}
        for r in (*runs, *reversed(runs)):
            got[r].append((time_ms(torch, runs[r], 10),
                           device_ms(runs[r], reps=10)))
        plain_ms2 = time_ms(torch, lambda: cb._bruteforce_topk_plain(
            qs, corpus, k_run, L2, n), 3)
        for r, wg in ((name, True), (HOPPER_OF[name], False)):
            ms = sum(t for t, _ in got[r]) / 2
            dev_ms = sum(t for _, t in got[r]) / 2
            qt, splits, q_res, smem = cb._launch_shape(
                b, n, k_run, sms, corpus.element_size(), d, wgmma=wg)
            log(f"launch shape of {r}: QT={qt}, {splits} splits, resident "
                f"queries {q_res}, {smem} bytes of shared memory per block")
            log(f"timing {r} at 1M x 128-d, B=1024, k=10 (k_run=12): "
                f"kernel {ms:.3f} ms ({b / ms * 1e3:.0f} QPS), device "
                f"{dev_ms:.3f} ms (CUDA graph), bound {bound:.3f} ms "
                f"({bound_by}; {bound / ms:.1%} of it reached), plain "
                f"{plain_ms:.3f} / {plain_ms2:.3f} ms, library (addmm + "
                f"topk) {lib_ms:.3f} ms; runs "
                f"{', '.join(f'{t:.3f}' for t, _ in got[r])}")
            out[r] = dict(max_abs_err=max_err[r], ms=ms, device_ms=dev_ms,
                          plain_ms=(plain_ms + plain_ms2) / 2,
                          bound_ms=bound, bound_by=bound_by,
                          library_ms=lib_ms)
        old = HOPPER_OF[name]
        log(f"{name} at 1M: {out[name]['ms']:.3f} ms against the "
            f"mma.sync {old}'s recorded {EARLIER_MS[old]:.3f} ms and "
            f"{out[old]['ms']:.3f} ms in this call "
            f"({out[name]['ms'] - out[old]['ms']:+.3f} ms)")
    for name in BUILD_SWEEPS + L1_SWEEPS:
        out[name] = dict(max_abs_err=max_err[name])
    return out


def products_s(b, n, d, bf16_values):
    """Seconds for the B N D products of a float32 query batch against n
    rows on the tensor cores: float32 rows in 3 TF32 passes (hi/lo
    splits); rows that are bf16 values (bf16 rows, int8 x scale elements,
    PQ-decoded rows) in the lesser of 2 TF32 passes and 3 bf16 passes (the
    query split into three bf16 parts) at the bf16 rate."""
    flops = 2.0 * b * n * d
    if not bf16_values:
        return 3 * flops / PEAK_TF32
    return min(2 * flops / PEAK_TF32, 3 * flops / PEAK_BF16)


def l1_bound_ms(b, n, d):
    """The least time of a Manhattan sweep: 2 B N D float32 operations (a
    subtraction and an addition a term) on the CUDA cores at the float32
    rate (the bytes are far less).  Returns (ms, "operations")."""
    return 2.0 * b * n * d / PEAK_F32 * 1e3, "operations"


def l1_ceiling_ms(torch, b, n, d):
    """Beside l1_bound_ms, the floor a Manhattan sweep can reach: the 67
    TFLOP/s count an FMA as two operations, but a subtraction and an
    addition are two FADDs that cannot fuse, so 2 B N D FADDs at the SMs'
    128 lanes and the card's max SM clock (nvidia-smi)."""
    from pg_embedding_tpu_torch.sweep_probe import (fadd_ceiling_ms,
                                                    max_sm_clock_hz)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return fadd_ceiling_ms(b, n, d, sms, max_sm_clock_hz())


def bound_ms(b, n, d, itemsize, k_run):
    """The least time the card could take for one launch: the products
    (products_s; rows of 1- and 2-byte elements are bf16 values) or the
    bytes (corpus and int8 rows' scales, queries, output lists) at the HBM
    rate, whichever is larger."""
    t_ops = products_s(b, n, d, itemsize < 4)
    nbytes = (n * (d * itemsize + (4 if itemsize == 1 else 0)) + b * d * 4
              + b * k_run * 8)
    t_bytes = nbytes / PEAK_BYTES
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
    """ptxas's registers and spills for each row sweep instance (the exact
    route's eight, the four wide float32 / bf16 ones, the four int8 ones
    and the twelve Manhattan ones), the PQ kernel's sweep (L2 / cosine and
    Manhattan) and select, and each walk, scan and wiring instance, and the
    HMMA count of each sweep in the built library's SASS; fails if a row
    instance but Manhattan's runs no TF32 HMMA, if a Manhattan instance
    runs any, if the PQ sweep runs no bf16 HMMA (or any TF32 one, or its
    Manhattan sweep any), or if one of the exact route's eight or the main
    path's two walk instances reports other registers or spills than
    before (SWEEP_PTXAS, WALK_PTXAS)."""
    def instance(mangled):
        m = re.search(r"sweep_wgmma_kernelI([ft])E", mangled)
        if m:
            return (f"sweep_wgmma_kernel<"
                    f"{'float' if m[1] == 'f' else 'bf16'}>")
        if "sweep_q8_wgmma_kernel" in mangled:
            return "sweep_q8_wgmma_kernel<int8>"
        m = re.search(r"sweep_kernel(_wide|_q8|_l1)?ILi(\d+)ELb([01])E"
                      r"([fta]?)E", mangled)
        if m:
            elem = dict(f="float", t="bf16", a="int8").get(m[4], "int8")
            return (f"sweep_kernel{m[1] or ''}<QT={m[2]}, "
                    f"{'resident' if m[3] == '1' else 'streamed'} queries, "
                    f"{elem}>")
        m = re.search(r"pq_sweep_kernelILb([01])E", mangled)
        if m:
            return (f"pq_sweep_kernel<"
                    f"{'Manhattan' if m[1] == '1' else 'L2 / cosine'}>")
        return "pq_select_kernel" if "pq_select_kernel" in mangled else None
    def graph_instance(mangled):
        elems = ("float32", "int8", "bf16", "pq", "pq unstaged",
                 "int8 staged", "bf16 staged", "float32 ring")
        m = re.search(r"beam_walk_kernelILi(\d)ELb([01])ELi(\d+)E",
                      mangled)
        if m:
            dedupe = "dense" if m[2] == "1" else "bitmap / hash"
            return (f"beam_walk_kernel<{elems[int(m[1])]} rows, {dedupe}, "
                    f"{m[3]} threads>")
        m = re.search(r"beam_walk_wide_kernelILi(\d)E", mangled)
        if m:
            return (f"beam_walk_wide_kernel<{elems[int(m[1])]} rows, any "
                    f"visited set, 256 threads>")
        m = re.search(r"prune_scan_regsILi(\d+)EE", mangled)
        if m:
            return f"prune_scan_regs<{m[1]} words>"
        m = re.search(r"connect_warp_kernelINS_\d+(F32|BF16)E", mangled)
        if m:
            return (f"connect_warp_kernel<"
                    f"{'float32' if m[1] == 'F32' else 'bf16'} rows>")
        m = re.search(r"connect_kernelINS_\d+(F32|BF16)ELb([01])E", mangled)
        if m:
            return (f"connect_kernel<{'float32' if m[1] == 'F32' else 'bf16'}"
                    f" rows, rows {'staged' if m[2] == '1' else 'in L2'}>")
        return ("prune_scan_kernel (words in shared memory)"
                if "prune_scan_kernel" in mangled else None)
    name, built, reports = None, set(), {}
    for line in _kernels.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = instance(m[1])
            if name:
                built.add(name)
            else:
                name = graph_instance(m[1])
        elif name and ("spill" in line or "Used" in line):
            log(f"ptxas {name}: {line.strip()}")
            if (name in SWEEP_PTXAS or name.startswith("beam_walk")):
                reports.setdefault(name, []).append(
                    re.sub(r"^ptxas\s+info\s*:\s*", "", line.strip()))
    lib = _kernels.load_library()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    counts, example, hgmma = {}, {}, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = instance(m[1])
        elif name and ("HMMA" in line or "HGMMA" in line):
            kind = ("TF32" if "TF32" in line else "BF16" if "BF16" in line
                    else "other")
            into = hgmma if "HGMMA" in line else counts
            into[name, kind] = into.get((name, kind), 0) + 1
            example.setdefault((name, kind), line.split(";")[0]
                               .split("*/")[-1].strip())
    for name, kind in sorted(counts):
        log(f"sass {name}: {counts[name, kind]} {kind} HMMA, e.g. "
            f"{example[name, kind]}")
    for name, kind in sorted(hgmma):
        log(f"sass {name}: {hgmma[name, kind]} {kind} HGMMA, e.g. "
            f"{example[name, kind]}")
    # the Manhattan register tile: a 4-dim step is 8 RQ RN FADDs against
    # RQ + RN 16-byte shared loads (256 against 12 at QT = 64)
    from pg_embedding_tpu_torch.sweep_probe import sass_report
    for fn, (regs, stack, fadd, lds, total) in sorted(
            sass_report(lib).items()):
        log(f"sass {instance(fn)}: {regs} registers, {stack} bytes stack, "
            f"{fadd} FADD, {lds} LDS.128 of {total} instructions")
    rows = {n for n in built if n.startswith("sweep_kernel")}
    l1 = {n for n in rows if n.startswith("sweep_kernel_l1")}
    tf32 = {n for n, k in counts if k == "TF32"}
    # the Hopper instances: TF32 wgmma (the int8 one's bf16) and no
    # mma.sync (the HMMA checks below hold every other L2 / cosine row
    # instance to TF32 HMMA)
    hopper = {n for n in built if n.startswith("sweep_wgmma_kernel")}
    q8_hopper = {n for n in built if n.startswith("sweep_q8_wgmma_kernel")}
    check(len(hopper) == 2 and len(q8_hopper) == 1
          and set(hgmma) == {*((n, "TF32") for n in hopper),
                             *((n, "BF16") for n in q8_hopper)},
          f"HGMMA by instance and kind: {sorted(hgmma)} (Hopper instances "
          f"built: {sorted(hopper | q8_hopper)})")
    check(len(rows) == 28 and len(l1) == 12 and tf32 == rows - l1,
          f"TF32 HMMA in {len(tf32)} of {len(rows)} row sweep instances "
          f"({len(l1)} Manhattan ones, which run none)")
    check(set(counts) == {*((n, "TF32") for n in rows - l1),
                          ("pq_sweep_kernel<L2 / cosine>", "BF16")},
          f"HMMA by kind: {sorted(counts)}")
    for name, want in {**SWEEP_PTXAS, **WALK_PTXAS}.items():
        check(reports.get(name) == list(want),
              f"ptxas {name}: {reports.get(name)}, earlier {want}")
    log(f"ptxas: the main path's walk instances keep their registers and "
        f"spills ({', '.join(WALK_PTXAS)})")
    # the PQ walk's instances (the distance table's row source: the codes
    # staged, and unstaged where the table and codes do not both fit)
    pq = {n: r for n, r in reports.items() if "<pq" in n}
    check(len(pq) == 10, f"PQ walk instances reported: {sorted(pq)}")
    for name, lines in sorted(pq.items()):
        log(f"ptxas PQ walk {name}: {'; '.join(lines)}")
    # the staged int8 / bf16 records instances (variant_vs_twin prints the
    # one each records walk takes)
    staged = [n for n in reports if " staged rows" in n]
    check(len(staged) == 10, f"staged records instances reported: "
          f"{sorted(staged)}")
    # the float32 records ring's instances (table instances only: dense or
    # a set, 128 or 256 threads)
    ring = {n: r for n, r in reports.items() if "<float32 ring" in n}
    check(len(ring) == 4, f"float32 ring instances reported: {sorted(ring)}")
    for name, lines in sorted(ring.items()):
        log(f"ptxas float32 records ring {name}: {'; '.join(lines)}")
    WALK_REPORTS.update(
        {n: r for n, r in reports.items() if n.startswith("beam_walk")})


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


def sweep_path_builds(torch, cb, HnswConfig, HnswIndex, dev):
    """The build sweep instances that the main path does not take, each
    over its own path: a 4,000-row build with build_candidates="exact" at
    each storage dtype (the wide float32 / bf16 instances), and an exact8
    build at ef_construction Q8_MMA_EFC, whose pool of 2 cand_cap = 320
    entries the rule keeps off the Hopper int8 instance (k_run past
    WIDE_MAX_K: bruteforce_topk_q8).  Every count set to 0 just before
    each: one launch of its instance a batch past the first and no other
    sweep, no torch-op loop, link rows >= 95% equal to the same build on
    the CPU.  Returns {instance: its launches}."""
    from pg_embedding_tpu_torch.core import build as core_build
    pts, _ = make_data(SEED + 11, 4000, 1)
    launches = {}
    for what, efc, kw, name in (
            ("exact mode, float32 rows", 64,
             dict(build_candidates="exact", storage_dtype="float32"),
             "bruteforce_topk_wide"),
            ("exact mode, bfloat16 rows", 64,
             dict(build_candidates="exact", storage_dtype="bfloat16"),
             "bruteforce_topk_bf16_wide"),
            (f"exact8, ef_construction {Q8_MMA_EFC}", Q8_MMA_EFC, {},
             "bruteforce_topk_q8")):
        cfg = HnswConfig(dims=DIMS, m=16, ef_construction=efc, ef_search=64)
        gpu = HnswIndex(cfg, device=dev, **kw)
        cpu = HnswIndex(cfg, device="cpu", **kw)
        loops = core_build.PLAIN_SWEEPS_ON_CARD
        reset_launches()
        gpu.build(pts)
        ran = dict(cb.LAUNCHES)
        cpu.build(pts)
        same = float((gpu.graph.links.cpu() == cpu.graph.links)
                     .all(dim=1)[:4000].float().mean())
        batches = len(core_build.build_schedule(len(pts),
                                                gpu.max_insert_batch))
        log(f"{what} build (4000 x 128-d) cuda vs cpu: identical link rows "
            f"{same:.4f}; sweep launches {ran}")
        check(ran[name] == batches - 1 and sum(ran.values()) == ran[name]
              and core_build.PLAIN_SWEEPS_ON_CARD == loops,
              f"{what}: {ran} over {batches} batches")
        check(same >= 0.95, f"{what}: link rows {same}")
        launches[name] = ran[name]
    return launches


class own_twin_calls:
    """Around the smoke's own calls of a plain twin on the card: the twins'
    counts (core/search.PLAIN_WALKS_ON_CARD, core/build.PLAIN_SWEEPS_ON_CARD
    and PLAIN_CONNECTS_ON_CARD) and the kernels' launch counts, by variant
    too, are put back as they were, so that what a path ran is counted and
    the comparisons are not."""

    def __enter__(self):
        from pg_embedding_tpu_torch.core import build as core_build
        from pg_embedding_tpu_torch.core import search as core_search
        from pg_embedding_tpu_torch.ops import cuda_bruteforce, cuda_graph
        self.saved = (core_search.PLAIN_WALKS_ON_CARD,
                      dict(cuda_bruteforce.LAUNCHES),
                      dict(cuda_graph.LAUNCHES),
                      dict(cuda_graph.WALK_VARIANTS),
                      core_build.PLAIN_SWEEPS_ON_CARD,
                      core_build.PLAIN_CONNECTS_ON_CARD)
        return self

    def __exit__(self, *exc):
        from pg_embedding_tpu_torch.core import build as core_build
        from pg_embedding_tpu_torch.core import search as core_search
        from pg_embedding_tpu_torch.ops import cuda_bruteforce, cuda_graph
        plain, bf, graph, variants, sweeps, connects = self.saved
        core_search.PLAIN_WALKS_ON_CARD = plain
        core_build.PLAIN_SWEEPS_ON_CARD = sweeps
        core_build.PLAIN_CONNECTS_ON_CARD = connects
        cuda_bruteforce.LAUNCHES.update(bf)
        cuda_graph.LAUNCHES.update(graph)
        cuda_graph.WALK_VARIANTS.clear()
        cuda_graph.WALK_VARIANTS.update(variants)
        return False


def reset_launches():
    """Set every kernel's launch count to 0."""
    from pg_embedding_tpu_torch.ops import cuda_bruteforce, cuda_graph
    for counts in (cuda_bruteforce.LAUNCHES, cuda_graph.LAUNCHES):
        for name in counts:
            counts[name] = 0
    cuda_graph.PRUNE_SHAPES.clear()


def launch_counts():
    """Every kernel's launch count, by name."""
    from pg_embedding_tpu_torch.ops import cuda_bruteforce, cuda_graph
    return {**cuda_bruteforce.LAUNCHES, **cuda_graph.LAUNCHES}


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

    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.core import search as core_search
    from pg_embedding_tpu_torch.ops import cuda_graph
    reset_launches()
    # the plain walks, torch-op candidate sweeps and plain wirings that
    # phases 4-11 run on the card (the smoke's own twin calls excepted):
    # read at the end
    cuda_graph.WALK_VARIANTS.clear()
    core_search.PLAIN_WALKS_ON_CARD = 0
    core_build.PLAIN_SWEEPS_ON_CARD = 0
    core_build.PLAIN_CONNECTS_ON_CARD = 0
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
    shapes = dict(cuda_graph.PRUNE_SHAPES)          # counted by the wrapper
    check(sum(shapes.values()) == cuda_graph.LAUNCHES["prune_scan"],
          "prune_scan's launches by shape do not sum to its launches")
    batches = len(core_build.build_schedule(n, idx.max_insert_batch))
    sweeps = cb.LAUNCHES["bruteforce_topk_q8_wgmma"]
    connects = cuda_graph.LAUNCHES["connect_batch"]
    log(f"build: {n} vectors in {build_s:.1f} s = {n / build_s:.0f} vec/s; "
        f"prune_scan launches by (C, nn): {dict(sorted(shapes.items()))}; "
        f"bruteforce_topk_q8_wgmma launches {sweeps} over {batches} batches "
        f"(exact8 from row 0: the first batch sweeps no rows); "
        f"connect_batch launches {connects}; torch-op sweeps on the card "
        f"{core_build.PLAIN_SWEEPS_ON_CARD}, plain wirings "
        f"{core_build.PLAIN_CONNECTS_ON_CARD}")
    check(sweeps == batches - 1 and sum(cb.LAUNCHES.values()) == sweeps,
          f"the build's sweep: {dict(cb.LAUNCHES)} launches over {batches} "
          f"batches, not one bruteforce_topk_q8_wgmma launch a batch past "
          f"the first")
    check(core_build.PLAIN_SWEEPS_ON_CARD == 0,
          "the build ran the torch-op sweep on the card")
    check(connects == batches and core_build.PLAIN_CONNECTS_ON_CARD == 0,
          f"the build's wiring: {connects} connect_batch launches and "
          f"{core_build.PLAIN_CONNECTS_ON_CARD} plain wirings over {batches} "
          f"batches, not one launch a batch")
    check(list(shapes) == [(idx.config.ef_construction * 2,
                            idx.config.m)],
          f"prune_scan ran at {sorted(shapes)}, not only the insert's "
          f"width (the re-prunes run inside connect_batch)")

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
    check(cb.LAUNCHES["bruteforce_topk_wgmma"] > 0,
          "search(mode='auto') did not launch the Hopper kernel")
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
    single = dict(exact_labels=el, exact_qps=exact_qps, graph_qps=graph_qps,
                  recall=rec, build_s=build_s, prune_shapes=shapes)
    log(f"exact_search: {exact_qps:.0f} QPS; search(mode='graph', "
        f"T={GRAPH_T}): {graph_qps:.0f} QPS at recall@10 {rec:.4f} vs the "
        f"exact route (the torch-op sweep's graph: {EARLIER_RECALL}; T=4: "
        f"recall@10 {recall(gl4, gv4, el):.4f})")
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
    launches = launch_counts()
    plain_walks = core_search.PLAIN_WALKS_ON_CARD
    log(f"main path kernel launches: {launches}; plain walks on the card: "
        f"{plain_walks}")
    check(plain_walks == 0, f"the main path ran {plain_walks} plain walks")
    return idx, pts, qs, launches, single


def median_ms(torch, fn, reps=5):
    """Median over ``reps`` calls of ``fn``'s time on the card (CUDA events
    around each call, after one warm call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def profile_call(torch, fn, logdir):
    """torch.profiler (CPU and CUDA activity) over one call of ``fn``:
    (wall ms under the profiler, device-busy ms, device operations: the
    kernels, copies and memsets the card ran, and the five host operations
    of most self CPU time); busy is None when the trace holds no device
    time."""
    from pg_embedding_tpu_torch.utils.profiling import trace
    torch.cuda.synchronize()
    with trace(logdir) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:5]
    top = ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms "
                    f"({e.count}x)" for e in host)
    return wall, (busy if ops else None), len(ops), top


def log_profile(what, wall, busy, n_ops, top):
    share = "not measured" if busy is None else (
        f"{busy:.3f} ms ({busy / wall:.1%})")
    log(f"profile of {what}: wall {wall:.3f} ms under the profiler, device "
        f"busy {share}, {n_ops} device operations; most host self time: "
        f"{top}")


def walk_bound_ms(hops, evals, b, dims, t, max_m, row_bytes=None,
                  visited=None):
    """The least time of a walk on the card: the bytes it must move (each
    processed neighbour's row, ``row_bytes`` each: float32 rows by default;
    each step's T link rows and counts; the queries; for a visited set
    ``visited`` = (words a query, 0 bitmap / 2^s hash), its initialisation
    and each processed id's words read and written) at the HBM rate; hops
    and evals from the kernel's counters."""
    row_bytes = dims * 4 if row_bytes is None else row_bytes
    n_evals = int(evals.sum())
    nbytes = (n_evals * row_bytes
              + int(hops.sum()) * t * (max_m + 1) * 4 + b * dims * 4)
    if visited is not None:
        words, slots = visited
        nbytes += b * words * 4 + n_evals * (8 if slots == 0 else 20)
    return nbytes / PEAK_BYTES * 1e3


def twin(core_search, graph, q, kw, walk):
    """The plain twin on ``graph`` / ``q``'s device with the wrapper's
    operands (records are its pcodes); the smoke's own call."""
    twin_kw = dict(kw)
    twin_kw["pcodes"] = twin_kw.pop("records", None)
    with own_twin_calls():
        return core_search._search_batch(graph, q, **walk, **twin_kw)


class sets_placed:
    """Inside it, every walk keeps its visited set where ``place`` says:
    None, where the placement rule (ops/cuda_graph._visited_place) keeps
    it; "device", in device memory (the rule refuses shared memory);
    "shared", in a table instance's shared memory wherever it fits,
    whatever an SM then holds (the rule with no residency to keep).  The
    other placement's walks, held to the twin as the rule's are."""

    def __init__(self, cg, place=None):
        self.cg, self.place = cg, place

    def __enter__(self):
        self.rule = rule = self.cg._visited_place
        if self.place == "device":
            self.cg._visited_place = lambda words, used, min_blocks: (0,
                                                                       False)
        elif self.place == "shared":
            self.cg._visited_place = lambda words, used, min_blocks: rule(
                words, used, 0)
        return self

    def __exit__(self, *exc):
        self.cg._visited_place = self.rule
        return False


def integer_walks(torch, cg, core_search, dev):
    """beam_walk against the plain twin on the card, bit for bit, on
    integer-coordinate indexes (3,000 x 32, integers in [-8, 8], built on
    the card): L2 and Manhattan, T in {1, 4, 8}, four (ef, cand_cap) over
    float32 rows; then every other row source (dense dedupe) and the
    bitmap and hash sets (float32 rows; each set where the rule keeps it
    and forced into the other placement: sets_placed) at T in {1, 4, 8}
    and (ef,
    cand_cap) in {(16, 16), (64, 128)}, PQ records (and OPQ's) also at
    (D, G) in PQ_INTEGER_GROUPS (the distance table at every group width)
    at PQ_INTEGER_SHAPES; then the wide instances (WIDE_QUEUES: every row
    source and visited set at (5120, 5120), float32 rows under every
    visited set at the others, T=4, 64 queries); then PQ walks at 1536-d
    whose table and codes do not both fit a block (pq_wide_row_walks).
    Returns the wide instances' launches."""
    from pg_embedding_tpu_torch import HnswConfig, HnswIndex
    from pg_embedding_tpu_torch.convert import to_numpy
    from walk_operands import integer_operands, on_device
    rng = np.random.default_rng(8)
    pts = rng.integers(-8, 9, size=(3000, 32)).astype(np.float32)
    qs = rng.integers(-8, 9, size=(256, 32)).astype(np.float32)
    q = torch.as_tensor(qs, device=dev)
    cases = variant_cases = wide_cases = 0
    staged_cases = {True: 0, False: 0}
    ring_cases = {True: 0, False: 0}
    set_cases = {True: 0, False: 0}
    pq_groups_seen = {"8 (D=32)"}
    wide0 = cg.WIDE_WALKS
    for name, metric in (("l2", L2), ("manhattan", 2)):
        idx = HnswIndex(HnswConfig(dims=32, m=8, ef_construction=32,
                                   ef_search=32, metric=name), device=dev)
        idx.build(pts)
        for t in (1, 4, 8):
            for ef, cap in ((16, 16), (64, 64), (64, 128), (128, 64)):
                kw = dict(ef=ef, metric_value=metric, cand_cap=cap,
                          expand_width=t)
                got = cg.beam_walk(idx.graph, q, **kw)
                want = twin(core_search, idx.graph, q, {}, kw)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"integer walk {name} T={t} ef={ef} cap={cap}: the "
                      f"kernel differs from the plain twin")
                cases += 1
        # float32 rows under the dense dedupe: only their wide cases here
        variants = ([("rows f32", -1)] + [(src, -1) for src in WALK_SOURCES]
                    + [("rows f32", vs) for vs in WALK_VISITED.values()])
        arrays = to_numpy(idx.graph)
        for source, vs in variants:
            g, kw = on_device(*integer_operands(arrays, qs, source)[::2],
                              dev)
            shapes = [(t, ef, cap) for t in (1, 4, 8)
                      for ef, cap in ((16, 16), (64, 128))
                      if (source, vs) != ("rows f32", -1)]
            wide = [(4, ef, cap) for ef, cap in WIDE_QUEUES
                    if source == "rows f32" or (ef, cap) == (5120, 5120)]
            runs = [(g, kw, q, shape) for shape in shapes + wide]
            if source in STAGED_SOURCES and vs == -1:
                runs.append((g, kw, q, RECORDS_UNSTAGED))
            if source.startswith("records pq"):
                # the PQ table at the other group widths
                for dims, groups in PQ_INTEGER_GROUPS:
                    cut = dict(arrays, vectors=np.ascontiguousarray(
                        arrays["vectors"][:, :dims]))
                    qd = np.ascontiguousarray(qs[:, :dims])
                    gg, kwg = on_device(*integer_operands(
                        cut, qd, source, groups=groups)[::2], dev)
                    runs += [(gg, kwg, torch.as_tensor(qd, device=dev),
                              shape) for shape in PQ_INTEGER_SHAPES]
                    pq_groups_seen.add(f"{groups} (D={dims})")
            for g, kw, q_run, (t, ef, cap) in runs:
                walk = dict(ef=ef, metric_value=metric, cand_cap=cap,
                            expand_width=t, visited_slots=vs)
                # the wide cases walk the first 64 queries (and OPQ's
                # rotated rows of them)
                qw, kww = q_run, kw
                if max(ef, cap) > 128:
                    qw = q_run[:64]
                    kww = {k: v[:64] if k == "query_t" else v
                           for k, v in kw.items()}
                # a set in a table instance: where the rule keeps it, then
                # forced into the other placement
                table_set = vs >= 0 and max(ef, cap) <= cg.MAX_WALK_QUEUE
                places = [None]
                if table_set:
                    src = cg._check_walk_args(g, qw, ef, cap, t, metric,
                                              visited_slots=vs, **kww)
                    places.append("device" if cg._walk_launch(
                        g, src, ef, cap, t, vs).visited_shared else "shared")
                for place in places:
                    with sets_placed(cg, place):
                        src = cg._check_walk_args(
                            g, qw, ef, cap, t, metric, visited_slots=vs,
                            **kww)
                        shared = cg._walk_launch(g, src, ef, cap, t,
                                                 vs).visited_shared
                        got = cg.beam_walk(g, qw, **walk, **kww)
                    want = twin(core_search, g, qw, kww, walk)
                    check(place is None or shared == (place == "shared"),
                          f"integer walk {source} visited_slots={vs} T={t} "
                          f"ef={ef} cap={cap}: the set shared {shared}, "
                          f"forced {place}")
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"integer walk {name} {source} visited_slots={vs} "
                          f"T={t} ef={ef} cap={cap}"
                          f"{f' (set forced {place})' if place else ''}: "
                          f"the kernel differs from the plain twin")
                    set_cases[shared] += vs >= 0
                if source in STAGED_SOURCES:
                    stage = cg._check_walk_args(
                        g, qw, ef, cap, t, metric, visited_slots=vs,
                        **kww).stage
                    staged = cg.records_staging(ef, cap, t, g.max_m,
                                                g.dims, stage) > 0
                    check(staged == ((t, ef, cap) != RECORDS_UNSTAGED),
                          f"integer walk {source} T={t} ef={ef} cap={cap}: "
                          f"staged {staged}")
                    staged_cases[staged] += 1
                if source == "records f32":
                    # the ring at every table shape (every set), none in
                    # the wide instances
                    stage = cg._check_walk_args(
                        g, qw, ef, cap, t, metric, visited_slots=vs,
                        **kww).stage
                    ringed = cg.records_staging(ef, cap, t, g.max_m, g.dims,
                                                stage) > 0
                    check(ringed == (max(ef, cap) <= cg.MAX_WALK_QUEUE),
                          f"integer walk records f32 T={t} ef={ef} "
                          f"cap={cap}: a ring {ringed}")
                    ring_cases[ringed] += 1
                if max(ef, cap) <= 128:
                    variant_cases += 1
                elif max(ef, cap) > cg.MAX_WALK_QUEUE:
                    wide_cases += 1
    wide_launches = cg.WIDE_WALKS - wide0
    log(f"beam_walk vs plain on the integer index: bit-equal in all {cases} "
        f"float32 cases (L2, Manhattan; T 1 / 4 / 8; four (ef, cand_cap)), "
        f"all {variant_cases} cases of the other row sources "
        f"({', '.join(WALK_SOURCES)}; PQ at G "
        f"{' / '.join(sorted(pq_groups_seen))}) and visited sets "
        f"(bitmap, hash; T 1 / 4 / 8; (16, 16), (64, 128)) and all "
        f"{wide_cases} cases of the "
        f"wide instances ({', '.join(map(str, WIDE_QUEUES))}; "
        f"{wide_launches} launches); ids, distances, hops and dist_evals; "
        f"the int8 / bf16 records and rows staged in shared memory in "
        f"{staged_cases[True]} of those cases, read from the records or "
        f"rows in {staged_cases[False]} more at (T, ef, cand_cap) = "
        f"{RECORDS_UNSTAGED}, bit-equal too; the f32 records through "
        f"their ring in {ring_cases[True]} cases, read from the records "
        f"in {ring_cases[False]} (the wide instances); the visited sets in "
        f"shared "
        f"memory in {set_cases[True]} cases and in device memory in "
        f"{set_cases[False]} (each table shape in both, one forced, and "
        f"the wide instances'), bit-equal too")
    pq_wide_row_walks(torch, cg, core_search, dev)
    return wide_launches


def pq_wide_row_walks(torch, cg, core_search, dev):
    """PQ walks at 1536-d (T 8, maxM 32, 3,000 integer rows with random
    links, integer codebooks: walk_operands.wide_row_operands) whose table
    and staged codes do not both fit a block: cosine at G 96 and L2 at G
    192 read the codes from the records beside a shared table, cosine at
    G 192 and L2 at G 384 build the table in device memory; at ef =
    cand_cap = 64 and 5120 (the wide instance).  L2 is bit-equal to the
    twin; cosine's rsqrt is not torch's, so its ids, hops and evals equal
    the twin's on >= 98% of queries, every other one at a near-tie."""
    from walk_operands import WIDE_ROW_PQ, on_device, wide_row_operands

    def near_tie(row):
        d = np.sort(row[np.isfinite(row)])
        return bool(np.any(np.diff(d) <= 1e-5 * np.abs(d[1:])))
    done = []
    for (metric, groups), where in WIDE_ROW_PQ.items():
        m = {"l2": L2, "cosine": 1}[metric]
        g, q_all, kw = wide_row_operands(groups)
        g, kw = on_device(g, kw, dev)
        for ef in (64, 5120):
            q = q_all[:128 if ef == 64 else 32].to(dev)
            walk = dict(ef=ef, metric_value=m, cand_cap=ef, expand_width=8)
            got = cg.beam_walk(g, q, **walk, **kw)
            want = twin(core_search, g, q, kw, walk)
            label = f"PQ walk at 1536-d {metric} G={groups} ef={ef}"
            if metric == "l2":
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{label}: the kernel differs from the plain twin")
            else:
                (dk, ik, hk, ek), (dp, ip, hp, ep) = [
                    [x.cpu().numpy() for x in r] for r in (got, want)]
                same = (ik == ip).all(axis=1) & (hk == hp) & (ek == ep)
                check(same.mean() >= 0.98 and all(
                    near_tie(dk[i]) or near_tie(dp[i])
                    for i in np.nonzero(~same)[0]),
                    f"{label}: ids equal on {same.mean():.3f} of queries, "
                    f"or a difference not at a near-tie")
            done.append(f"{metric} G={groups} ({where} table) ef={ef}")
    log(f"beam_walk vs plain, PQ at 1536-d where the table and codes do "
        f"not both fit a block: {'; '.join(done)}: L2 bit-equal, cosine "
        f"within the near-tie bar")


def walk_kernels_phase(torch, idx, qs, dev, tmp, single, profile_lib):
    """Phase 4b: the walk and prune kernels against their plain twins on
    the main index, timed beside their bounds, the graph route and one
    insert batch profiled, and each kernel's phases.  Returns {kernel name:
    the JSON line's numbers}."""
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.core import search as core_search
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    from pg_embedding_tpu_torch.graph_probe import device_ms
    from pg_embedding_tpu_torch.ops.cuda_bruteforce import fused_exact_search
    g, n = idx.graph, idx.n_nodes
    q = torch.as_tensor(qs, device=dev)
    b, max_m = len(qs), g.max_m
    # the walk ignores tombstones (they stay waypoints): its truth is the
    # exact route over every stored row
    _, truth = fused_exact_search(q, g.vectors, K, n_valid=n)
    truth = truth.cpu().numpy()
    out = {}
    for t in WALK_TS:
        kw = dict(ef=WALK_EF, metric_value=L2, cand_cap=WALK_EF,
                  expand_width=t)
        with own_twin_calls():
            kd, ki, kh, ke = cg.beam_walk(g, q, **kw)
        pd, pi, ph, pe = twin(core_search, g, q, {}, kw)
        ki_np, pi_np = ki.cpu().numpy(), pi.cpu().numpy()
        rec_k = recall(ki_np, ki_np >= 0, truth)
        rec_p = recall(pi_np, pi_np >= 0, truth)
        same = (ki == pi).all(dim=1)
        n_diff = int((~same).sum())
        err = float((kd[same] - pd[same]).abs().max()) if same.any() else 0.0
        hk, hp = float(kh.float().mean()), float(ph.float().mean())
        ek, ep = float(ke.float().mean()), float(pe.float().mean())
        with own_twin_calls():
            dev_ms = device_ms(lambda: cg.beam_walk(g, q, **kw))
            ms = median_ms(torch, lambda: cg.beam_walk(g, q, **kw))
            plain_ms = median_ms(torch, lambda: core_search._search_batch(
                g, q, **kw))
        bound = walk_bound_ms(kh, ke, b, g.dims, t, max_m)
        log(f"beam_walk vs plain at {n} rows, {b} queries, ef={WALK_EF}, "
            f"T={t}: "
            f"recall@10 {rec_k:.4f} / {rec_p:.4f} vs the exact route; ids "
            f"differ on {n_diff} of {b} queries; mean hops {hk:.2f} / "
            f"{hp:.2f} (max {int(kh.max())}), dist_evals {ek:.1f} / "
            f"{ep:.1f}; max_abs_err {err:.3g} where ids agree; kernel "
            f"{ms:.3f} ms a call, plain {plain_ms:.3f} ms (median of 5, "
            f"CUDA events); kernel {dev_ms:.3f} ms on the card (a CUDA "
            f"graph of 20 calls); bound {bound:.4f} ms (bytes; "
            f"{bound / dev_ms:.1%} of it reached on the card)")
        check(abs(rec_k - rec_p) <= 0.002,
              f"T={t}: walk recall {rec_k} vs the twin's {rec_p}")
        check(n_diff <= 0.02 * b, f"T={t}: ids differ on {n_diff} queries")
        check(abs(hk - hp) <= 0.01 * hp and abs(ek - ep) <= 0.01 * ep,
              f"T={t}: hops {hk} / {hp}, evals {ek} / {ep}")
        if t == GRAPH_T:
            out["beam_walk"] = dict(max_abs_err=err, ms=ms,
                                    device_ms=dev_ms, plain_ms=plain_ms,
                                    bound_ms=bound, bound_by="bytes",
                                    library_ms=None)
    with own_twin_calls():
        out["beam_walk"]["integer_wide_launches"] = integer_walks(
            torch, cg, core_search, dev)

    profiles = os.path.join(tmp, "profiles")
    for t in WALK_TS:
        idx.search_expand_width = t
        log_profile(f"search(mode='graph'), {b} queries, T={t} ef="
                    f"{idx.config.ef_search}",
                    *profile_call(torch, lambda: idx.search(qs, K,
                                                            mode="graph"),
                                  os.path.join(profiles, f"walk_t{t}")))
    idx.search_expand_width = GRAPH_T

    # one real 256-row insert batch at 1M: its insert prune's scan (C =
    # cand_cap), its sweep and its wiring's inputs (the graph's links and
    # counts as they were before it)
    captured, sweeps, wirings = {}, [], []
    real, real_sweep = core_build.prune_scan, core_build.sweep_pool
    real_connect = core_build._connect_batch

    def spy(*args):
        captured.setdefault(args[0].shape[1], tuple(
            a.clone() if hasattr(a, "clone") else a for a in args))
        return real(*args)

    def sweep_spy(points, rows, *args):
        # the shadow's rows below base never change: kept, not cloned
        sweeps.append((points.clone(), rows, *args))
        return real_sweep(points, rows, *args)

    def connect_spy(vectors, links, counts, base, kept_i, kept_cnt,
                    n_insert, **kw):
        wirings.append((vectors, links.clone(), counts.clone(), base,
                        kept_i.clone(), kept_cnt.clone(), n_insert, kw))
        return real_connect(vectors, links, counts, base, kept_i, kept_cnt,
                            n_insert, **kw)
    rows = add_rows(idx, qs, SEED + 7)
    core_build.prune_scan, core_build.sweep_pool = spy, sweep_spy
    core_build._connect_batch = connect_spy
    try:
        log_profile(f"add() of one {len(rows)}-row insert batch at {n} "
                    f"rows", *profile_call(torch, lambda: idx.add(rows),
                                           os.path.join(profiles,
                                                        "insert")))
    finally:
        core_build.prune_scan, core_build.sweep_pool = real, real_sweep
        core_build._connect_batch = real_connect
    shutil.rmtree(profiles)
    c = idx.config.ef_construction * 2
    check(list(captured) == [c] and len(wirings) == 1,
          f"the add() ran prune widths {sorted(captured)} and "
          f"{len(wirings)} wirings, not only the insert's prune and one "
          f"wiring (its re-prunes run inside connect_batch)")
    shapes = single["prune_shapes"]
    d_s, valid_s, order, pair, do_prune, nn = captured[c]
    bsz = d_s.shape[0]
    got = cg.prune_scan(d_s, valid_s, order, pair, do_prune, nn)
    want = core_build._prune_scan_plain(d_s, valid_s, order, pair, do_prune,
                                        nn)
    check(all(torch.equal(x, y) for x, y in zip(got, want)),
          "prune_scan differs from the plain twin at the insert shape")
    with own_twin_calls():
        dev_ms = device_ms(lambda: cg.prune_scan(d_s, valid_s, order, pair,
                                                 do_prune, nn))
        ms = median_ms(torch, lambda: cg.prune_scan(d_s, valid_s, order,
                                                    pair, do_prune, nn))
        plain_ms = median_ms(torch, lambda: core_build._prune_scan_plain(
            d_s, valid_s, order, pair, do_prune, nn))
    kept = got[0].int()
    before = torch.cumsum(kept, dim=1) - kept          # kept before each j
    tested = valid_s & (before < nn) & do_prune.unsqueeze(1)
    pairs = int((before * tested).sum())
    nbytes = pairs * 4 + bsz * c * (4 + 1 + 8 + 1) + bsz * (1 + 4)
    bound = nbytes / PEAK_BYTES * 1e3
    launches = sum(v for (sc, _), v in shapes.items() if sc == c)
    reprune_launches = sum(v for (sc, _), v in shapes.items()
                           if sc == max_m + 1)
    log(f"prune_scan vs plain at the insert shape at {n} rows (B={bsz}, "
        f"C={c}, nn={nn}, {int(do_prune.sum())} sets pruned, {pairs} pairs "
        f"tested; {launches} launches of this width and {reprune_launches} "
        f"of the re-prune's, C = {max_m + 1}, in the main path's build): "
        f"bit-equal; kernel {ms:.4f} ms a call, plain {plain_ms:.3f} ms "
        f"(median of 5, CUDA events); kernel {dev_ms:.4f} ms on the card (a "
        f"CUDA graph of 20 calls); bound {bound:.5f} ms (bytes; "
        f"{bound / dev_ms:.1%} of it reached on the card)")
    out["prune_scan"] = dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_by="bytes", library_ms=None,
                             insert_launches=launches,
                             reprune_launches=reprune_launches)
    phase_breakdown(torch, g, q, captured, profile_lib)
    check(len(sweeps) == 1, f"the add() ran {len(sweeps)} candidate sweeps")
    out.update(sweep_phase(torch, idx, sweeps[0]))
    out["connect_batch"] = connect_phase(torch, wirings[0])
    del wirings
    out["connect_batch"]["add"] = add_phase(torch, idx, qs)
    return out


def add_rows(idx, qs, seed):
    """One insert batch near the main index's queries ``qs``: the first
    max_insert_batch of them plus noise."""
    rows = qs[:idx.max_insert_batch]
    return (rows + np.random.default_rng(seed).normal(
        scale=0.1, size=rows.shape)).astype(np.float32)


def loop_pool(points, rows, keep, metric_value, base):
    """sweep_pool's torch-op counterpart, the route the card ran before the
    kernel: core/build's chunk loop (core/build._sweep_loop) at the
    default chunk of 1,048,576 rows, a [B, chunk] float32 score tile a
    step.  It counts in PLAIN_SWEEPS_ON_CARD: the smoke calls it inside
    own_twin_calls."""
    from pg_embedding_tpu_torch.core import build as core_build
    scaled = isinstance(rows, tuple)
    return core_build._sweep_loop(None if scaled else rows, points, base,
                                  keep, metric_value, core_build.EXACT8_CHUNK,
                                  *(rows if scaled else ()))


def sweep_yardstick_ms(torch, points, rows, keep):
    """library_ms of the build's sweep: torch.matmul of the batch against
    ``rows`` (float32; the int8 shadow dequantised before the timing), in
    full float32, then torch.topk to the pool, a chunk of 1,048,576 rows at
    a time (CUDA events, median of 5).  The port never calls it."""
    def batch():
        for start in range(0, len(rows), 1_048_576):
            dist = torch.matmul(points, rows[start:start + 1_048_576].T)
            torch.topk(dist, keep, dim=1, largest=False, sorted=False)
    return median_ms(torch, batch)


def sweep_phase(torch, idx, args):
    """The build's candidate sweep on the add()'s own batch (``args``:
    sweep_pool's points, int8 shadow, pool, metric and base), in each mode:
    exact8 (bruteforce_topk_q8_wgmma over the shadow, pool 2 cand_cap, and
    beside it the mma.sync bruteforce_topk_q8 forced on the same batch,
    "exact8 mma.sync") and exact mode (bruteforce_topk_wide over the index's float32 rows and
    bruteforce_topk_bf16_wide over their bf16 values, pool cand_cap + 2).
    Each pool against its plain twin (_bruteforce_topk_plain) on the card
    (distances within the cancellation tolerance of phase 9, ids equal
    except float64 near-ties), the final cand_cap after the exact rerank
    equal on >= 99.9% of the batch's rows (exact8); its time a call and on
    the card beside the bound, the twin, the torch-op loop it replaced
    (loop_pool) and the library call (torch.matmul + torch.topk for exact8,
    addmm + topk for exact mode), all in this run, which the kernel must
    beat on the card.  Then Manhattan's exact8 sweep on the same batch and
    shadow (bruteforce_topk_q8_l1, the CUDA cores' sum; the library call
    torch.cdist(p=1) + torch.topk over the dequantised rows, its bound the
    2 B N D float32 operations at 67 TFLOP/s).  Returns the kernels line's
    numbers by instance."""
    from pg_embedding_tpu_torch.graph_probe import device_ms
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
    from pg_embedding_tpu_torch.ops.bruteforce import _rerank_exact
    points, shadow, keep, metric, base = args
    b, d = points.shape
    cand_cap = keep // 2
    vectors = idx.graph.vectors
    out = {}
    for mode, rows, pool in (("exact8", shadow, keep),
                             ("exact8 mma.sync", shadow, keep),
                             ("exact", vectors, cand_cap + 2),
                             ("exact bf16", vectors.to(torch.bfloat16),
                              cand_cap + 2),
                             ("exact8 manhattan", shadow, keep)):
        scaled = mode.startswith("exact8")
        if mode == "exact8 manhattan":
            metric = MANHATTAN
        dense = (cb.dequantize_rows(shadow[0][:base], shadow[1][:base])
                 .float() if scaled else rows[:base].float())
        name, wgmma = cb.launch_instance(points, rows, pool, metric)
        forced = mode == "exact8 mma.sync"
        if mode == "exact8":
            check(wgmma and name == "bruteforce_topk_q8_wgmma",
                  f"the build's batch took {name}, not the Hopper instance")
        if forced:
            name = cb._instance(torch.int8, pool)[0]

        def kernel():
            if forced:                  # the rule's choice overridden
                return cb._launch(points, torch.int8,
                                  tuple(t.data_ptr() for t in rows), 1, base,
                                  rows[0].shape[0], pool, metric, None, None,
                                  False)
            return cb.sweep_pool(points, rows, pool, metric, base)

        def twin():
            return cb._bruteforce_topk_plain(points, rows, pool, metric,
                                             base)

        def loop():
            return loop_pool(points, rows, pool, metric, base)
        with own_twin_calls():
            got, want, old = kernel(), twin(), loop()
            torch.cuda.synchronize()
            err, swaps = compare(torch, got, want, points, dense, metric,
                                 base, None, cancel_units=SHARD_UNITS
                                 if metric != MANHATTAN else 0)
            final = [_rerank_exact(points, vectors, r[1], k=cand_cap,
                                   metric_value=metric)[1]
                     for r in (got, want, old)]
            same = float((final[0] == final[1]).all(1).float().mean())
            same_loop = float((final[0] == final[2]).all(1).float().mean())
            ms = median_ms(torch, kernel)
            dev_ms = device_ms(kernel)
            plain_ms = median_ms(torch, twin)
            loop_ms = median_ms(torch, loop)
        ceiling = ""
        if metric == MANHATTAN:
            lib_ms = median_ms(torch, lambda: torch.topk(
                torch.cdist(points, dense, p=1.0), pool, dim=1,
                largest=False, sorted=False))
            bound, bound_by = l1_bound_ms(b, base, d)
            ceiling_ms = l1_ceiling_ms(torch, b, base, d)
            ceiling = (f"; FADD ceiling {ceiling_ms:.4f} ms ("
                       f"{ceiling_ms / dev_ms:.1%} of it reached)")
        else:
            lib_ms = (sweep_yardstick_ms(torch, points, dense, pool)
                      if scaled else library_ms(torch, points, dense, pool))
            bound, bound_by = bound_ms(b, base, d,
                                       (rows[0] if scaled else rows)
                                       .element_size(), pool)
        earlier = EARLIER_SWEEP_MS.get(mode)
        before = ("" if earlier is None
                  else f"; {earlier} before the wide selection")
        if mode == "exact8":
            before += (f"; the mma.sync instance {EARLIER_Q8_MS} before the "
                       f"Hopper one, PR 12's smoke")
        log(f"the build's sweep ({mode}: {name}) on the add()'s batch at "
            f"{base} rows, B={b}, pool {pool}: vs its plain twin "
            f"max_abs_err {err:.3g}, {swaps} float64 near-tie id swaps; "
            f"final {cand_cap} candidates after the exact rerank equal on "
            f"{same:.4f} of rows ({same_loop:.4f} against the torch-op "
            f"loop's); kernel {ms:.3f} ms a call, {dev_ms:.3f} ms on the "
            f"card (a CUDA graph of 20 calls"
            f"{before}"
            f"); bound {bound:.4f} ms ({bound_by}; {bound / dev_ms:.1%} of it "
            f"reached on the card){ceiling}; plain twin {plain_ms:.3f} ms; "
            f"the torch-op loop it replaced {loop_ms:.3f} ms; library "
            f"({'torch.cdist' if metric == MANHATTAN else 'torch.matmul' if scaled else 'torch.addmm'} + torch.topk) "
            f"{lib_ms:.3f} ms (median of 5, CUDA events)")
        if metric != MANHATTAN:
            check(dev_ms < lib_ms, f"{mode}: the kernel's {dev_ms:.3f} ms on "
                  f"the card is not below the library call's {lib_ms:.3f} ms")
        # exact mode's pad of 2 leaves the rerank no room for a pool-edge
        # near-tie (the pool itself is held above); exact8's pool is 2x
        if scaled:
            check(same >= 0.999, f"{mode}: final candidates equal on {same}")
        out[name] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, loop_ms=loop_ms, bound_ms=bound,
                         bound_by=bound_by, library_ms=lib_ms)
        if metric == MANHATTAN:
            out[name]["ceiling_ms"] = ceiling_ms
        del dense
    return out


def connect_bound_ms(stats, bm, b, n_insert, max_m, dims, itemsize):
    """The least time of one wiring on the card, from the kernel's counters
    for these inputs (stats: chains, ops, re-prunes, pruned re-prunes,
    pairs turned into masks, valid candidates): the bytes it must move (the
    sorted ops' keys and indices; the members' kept lists and counts read
    and the n_insert forward rows and counts written; each chain's row and
    count read and written once; each re-prune's target row and valid
    candidates' rows read once) over the memory rate, or its float32
    operations (a D-wide dot product or difference sum, 2 D, per pair and
    per candidate) over the float32 rate, whichever is larger.  ``b``
    members of m = bm / b slots.  Returns (ms, "bytes" or
    "operations")."""
    chains, _, reprunes, _, pairs, valid = (int(x) for x in stats[:6])
    nbytes = (bm * 12 + (bm + b) * 4 + n_insert * (4 * max_m + 4)
              + chains * (8 * max_m + 8)
              + (valid + reprunes) * dims * itemsize)
    ops = 2 * dims * (pairs + valid)
    by_bytes, by_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


# (maxM, D, b, base) of the integer-row cases: the warp tier at the main
# path's maxM 32 and D = 128, at its widest set (C = 64) and at rows of 7
# elements (no whole 16-byte chunks); the block tier one past it (C = 65)
# and at the default m = 100, staged (D = 8) and masks only (D = 400);
# masks in device memory (maxM 1400)
CONNECT_INTEGER_SHAPES = ((32, 128, 32, 300), (63, 8, 16, 300),
                          (32, 7, 32, 300), (64, 8, 16, 300),
                          (200, 8, 16, 300), (200, 400, 16, 300),
                          (1400, 8, 4, 1500))


def connect_integer_cases(torch, dev):
    """connect_batch bit-equal to its plain twin on the card on integer
    rows (tests/connect_operands.py: every sum exact), every metric,
    float32 and bf16 rows, each tier (CONNECT_INTEGER_SHAPES), and chains
    of more than 32 ops that re-prune again and again (long_chain_case).
    Returns the number of cases."""
    from connect_operands import (kernel_and_twin, long_chain_case,
                                  wiring_case)
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    # the twin's bf16 cosine dot accumulated in float32 and rounded once
    matmul.allow_bf16_reduced_precision_reduction = False
    cases = 0
    try:
        for shape in (*CONNECT_INTEGER_SHAPES, "long chains"):
            for metric in (0, 1, 2):
                for dtype in (torch.float32, torch.bfloat16):
                    if shape == "long chains":
                        arrays, meta = long_chain_case(metric)
                        what = "chains past 32 ops (maxM 32, D 8)"
                    else:
                        max_m, dims, b, base = shape
                        arrays, meta = wiring_case(
                            max_m + dims + metric, max_m, b=b,
                            n_insert=b - 3, base=base, dims=dims)
                        what = f"maxM {max_m}, D {dims}"
                    with own_twin_calls():
                        (kl, kc), (pl, pc), launches = kernel_and_twin(
                            arrays, meta, metric, dev, dtype)
                    what += f" ({cg.LAST_CONNECT_LAUNCH.tier} tier)"
                    check(launches == 1 and torch.equal(kl, pl)
                          and torch.equal(kc, pc),
                          f"connect_batch differs from its twin on integer "
                          f"rows: {what}, metric {metric}, {dtype}")
                    cases += 1
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    return cases


def connect_phase(torch, wiring):
    """The wiring of the add()'s own batch (``wiring``: _connect_batch's
    inputs as the add() passed them, links and counts as they were before
    it) on copies of the graph's links: one connect_batch launch against
    its plain twin (core/build._connect_sorted_plain: _forward_links, then
    the rounds of _replay_chains) on the card, both from the card route's
    operands (_back_link_targets, _chain_order).  Every member's row and
    every target whose chain only appends (its count after the forward
    rows plus its chain's length at most maxM) must get the twin's row and
    count exactly; of the targets re-pruned at least once, >= 99% must
    (the kernel sums in another order than torch's reductions and cuBLAS,
    so float32 near-ties may break otherwise; every reading so far was 1),
    and the share that differs is the kernels line's "max_abs_err"; the
    kernel's launch shape and counters (chains, ops, re-prunes); its time
    a call (CUDA events, median of 5, the touched rows restored before
    each call outside the timing) and on the card (a CUDA graph of 20
    restores and launches, less one of the 20 restores alone) beside its
    bound (connect_bound_ms) and the twin's time a call; for each re-pruned
    row that differs, tests/connect_operands.reprune_witness's margin at
    its first diverging keep/reject (pair - d in float32 ulps of d, in the
    twin's float32 and in float64) and whether the float64 replay sides
    with the kernel or the twin, and over every re-pruned row how often
    each equals the float64 replay; then connect_integer_cases.  Returns
    the kernels line's numbers."""
    from connect_operands import chain_targets, reprune_witness
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.graph_probe import device_ms
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    vectors, links0, counts0, base, kept_i, kept_cnt, n_insert, kw = wiring
    max_m, m, dims, dev = kw["max_m"], kw["m"], vectors.shape[1], \
        vectors.device
    links, counts = links0.clone(), counts0.clone()
    keys, perm = core_build._chain_order(core_build._back_link_targets(
        kept_i, kept_cnt, n_insert, m=m))
    # the counts each chain starts from (a member's: its forward row's)
    fwd_links, fwd_counts = links0.clone(), counts0.clone()
    core_build._forward_links(fwd_links, fwd_counts, base, kept_i, kept_cnt,
                              n_insert, m=m, max_m=max_m)
    targets, repruned = chain_targets(keys, fwd_counts, max_m)
    members = torch.arange(base, base + n_insert, device=dev)
    touched = torch.unique(torch.cat([targets, members]))
    repruned_t = torch.zeros(len(touched), dtype=torch.bool, device=dev)
    repruned_t[torch.searchsorted(touched, targets[repruned])] = True
    start_rows, start_counts = links[touched].clone(), counts[touched].clone()
    bm, b = keys.numel(), kept_i.shape[0]
    args = (keys, perm, kept_i, kept_cnt)
    kwargs = dict(kw, base=base, n_insert=n_insert)

    def restore():
        links[touched] = start_rows
        counts[touched] = start_counts

    def kernel():
        cg.connect_batch(vectors, links, counts, *args, **kwargs)

    def twin():
        core_build._connect_sorted_plain(vectors, links, counts, *args,
                                         **kwargs)

    def timed(fn):
        times = []
        for _ in range(6):
            restore()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times[1:]))

    stats = torch.zeros(8, dtype=torch.int64, device=dev)
    with own_twin_calls():
        cg.CONNECT_STATS = stats
        try:
            kernel()
        finally:
            cg.CONNECT_STATS = None
        shape = cg.LAST_CONNECT_LAUNCH
        got = links[touched].clone(), counts[touched].clone()
        restore()
        twin()
        want = links[touched].clone(), counts[touched].clone()
        ms, plain_ms = timed(kernel), timed(twin)
        dev_ms = (device_ms(lambda: (restore(), kernel()))
                  - device_ms(restore))
    same = (got[0] == want[0]).all(dim=1) & (got[1] == want[1])
    n_re = int(repruned_t.sum())
    rows_equal = int(same.sum()) / len(touched)
    others_equal = bool(same[~repruned_t].all())
    reprune_rows_equal = int(same[repruned_t].sum()) / max(n_re, 1)
    st = stats.tolist()
    bound, bound_by = connect_bound_ms(st, bm, b, n_insert, max_m, dims,
                                       vectors.element_size())
    # the re-pruned rows against a float64 replay, and the margin where a
    # row differs from the twin's
    rep = repruned_t.nonzero().squeeze(1)
    with own_twin_calls():
        witness = reprune_witness(
            vectors, fwd_links, fwd_counts, keys, perm, touched[rep],
            got[0][rep], got[1][rep], base=base, m=m, max_m=max_m,
            metric=kw["metric_value"])
    kernel_f64 = sum(w["kernel_row"] == w["f64_row"] for w in witness)
    twin_f64 = sum(w["twin_row"] == w["f64_row"] for w in witness)
    # the witness's own float32 replay, a chain at a time, against the
    # twin's rows (its rounds batch the re-prunes)
    replayed = sum(w["twin_row"] == want[0][i, :int(want[1][i])].tolist()
                   for w, i in zip(witness, rep.tolist()))
    log(f"connect_batch's re-pruned rows against a float64 replay "
        f"(difference forms, float64 sums): the kernel's equal it on "
        f"{kernel_f64} of {len(witness)}, the twin's on {twin_f64}; the "
        f"witness's float32 replay a chain at a time gives the twin's row "
        f"on {replayed}")
    for w in witness:
        if w["kernel_row"] == w["twin_row"]:
            continue
        if w["kind"] == "tie":
            at = (f"the same candidates in another order from slot "
                  f"{w['position']}: d of the kernel's candidate there less "
                  f"the twin's {w['margin_ulps']} ulps in the twin's float32"
                  f", {w['f64_margin_ulps']} in float64")
        else:
            at = (f"first diverging keep/reject at scan position "
                  f"{w['position']}, decided by {w['kind']}; pair - d "
                  f"{w['margin_ulps']} ulps of d in the twin's float32, "
                  f"{w['f64_margin_ulps']} in float64; d's nearest "
                  f"neighbour in the scan {w['gap_ulps']} ulps away")
        log(f"  re-pruned row {w['target']} differs ({w['reprunes']} "
            f"re-prunes): {at}; the float64 row equals the kernel's "
            f"{w['f64_row'] == w['kernel_row']}, the twin's "
            f"{w['f64_row'] == w['twin_row']}")
    cases = connect_integer_cases(torch, dev)
    log(f"connect_batch vs its plain twin on the add()'s batch ({st[1]} "
        f"valid ops of bm = {bm}, {n_insert} members, maxM {max_m}, D "
        f"{dims}; launched as the {shape.tier} tier, {shape.blocks} blocks "
        f"of {shape.threads} threads, {shape.smem} bytes of shared memory a "
        f"block): {st[0]} chains "
        f"(longest {st[6]}), {st[2]} re-prunes ({st[3]} pruned, {st[4]} "
        f"pairs into masks); rows and counts of the {len(touched)} touched "
        f"rows equal {rows_equal:.5f}: the {len(touched) - n_re} members "
        f"and targets that only append "
        f"{'all' if others_equal else 'NOT all'} equal, the {n_re} "
        f"re-pruned {reprune_rows_equal:.5f} (limit 0.99); kernel {ms:.4f} "
        f"ms a call (median of 5, CUDA "
        f"events), {dev_ms:.4f} ms on the card (a CUDA graph of 20 restores "
        f"and launches less 20 restores); bound {bound:.5f} ms ({bound_by};"
        f" {bound / dev_ms:.1%} of it reached on the card); plain twin "
        f"{plain_ms:.3f} ms a call; bit-equal to the twin on {cases} "
        f"integer-row cases (every metric, float32 / bf16, each tier, long "
        f"chains)")
    check(0 < n_re <= st[2],
          f"{n_re} re-pruned targets for the kernel's {st[2]} re-prunes")
    check(others_equal and reprune_rows_equal >= 0.99,
          f"connect_batch and its twin: members and targets that only "
          f"append all equal {others_equal}, re-pruned targets equal "
          f"{reprune_rows_equal}")
    return dict(max_abs_err=1.0 - reprune_rows_equal, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None, rows_equal=rows_equal,
                reprune_rows_equal=reprune_rows_equal,
                reprune_targets=n_re, reprunes=st[2], ops=st[1],
                chains=st[0])


def add_phase(torch, idx, qs, n_adds=8):
    """``n_adds`` more 256-row add()s at 1M through the kernels, on the host
    clock, each broken down by stage (the int8 shadow's staging, the
    sweep's launch, the insert's prune, the wiring) with the host's
    synchronising calls on CUDA tensors counted (int() / bool() / float()
    / item() / nonzero() / tolist() / cpu(): none is allowed) and the one
    wait left, the closing synchronisation, timed; the wiring's counters
    (ops/cuda_graph.CONNECT_STATS: re-prunes a batch) and the peak device
    memory; then one add() with core/build's sweep swapped for the
    torch-op loop (loop_pool, inside own_twin_calls), its peak memory
    beside.  Returns the numbers printed."""
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    spent, syncs, stack, patched = {}, {}, [], []

    def wrap(owner, name, key):
        fn = getattr(owner, name)
        patched.append((owner, name, vars(owner).get(name)))

        def timed(*a, **kw):
            k = key() if callable(key) else key
            stack.append(k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                stack.pop()
                spent[k] = spent.get(k, 0.0) + dt
                if stack:                   # an inner stage's time is its own
                    spent[stack[-1]] = spent.get(stack[-1], 0.0) - dt
        setattr(owner, name, timed)

    def count_sync(name):
        fn = getattr(torch.Tensor, name)
        patched.append((torch.Tensor, name, vars(torch.Tensor).get(name)))

        def counted(self, *a, **kw):
            if self.is_cuda:
                k = f"{stack[-1] if stack else 'add'}: {name.strip('_')}()"
                syncs[k] = syncs.get(k, 0) + 1
            return fn(self, *a, **kw)
        setattr(torch.Tensor, name, counted)
    wrap(idx, "_stage_shadow", "stage shadow")
    wrap(core_build, "_exact_candidates", "sweep")
    wrap(core_build, "_prune_heuristic", "prune")
    wrap(core_build, "_connect_batch", "connect")
    for sync in ("__int__", "__bool__", "__float__", "item", "nonzero",
                 "tolist", "cpu"):
        count_sync(sync)
    stats = torch.zeros(8, dtype=torch.int64, device=idx.device)
    runs, peak = [], {}
    try:
        cg.CONNECT_STATS = stats
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_adds):
            rows = add_rows(idx, qs, SEED + 20 + i)
            torch.cuda.synchronize()
            spent.clear()
            t0 = time.perf_counter()
            idx.add(rows)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            runs.append(dict(wall=(t2 - t0) * 1e3, wait=(t2 - t1) * 1e3,
                             **{k: v * 1e3 for k, v in spent.items()}))
        cg.CONNECT_STATS = None
        counted = dict(syncs)
        peak["kernel"] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
        rows = add_rows(idx, qs, SEED + 9)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        real = core_build.sweep_pool
        with own_twin_calls():
            core_build.sweep_pool = loop_pool
            try:
                idx.add(rows)
            finally:
                core_build.sweep_pool = real
        torch.cuda.synchronize()
        peak["twin"] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    finally:
        cg.CONNECT_STATS = None
        for owner, name, saved in reversed(patched):
            if saved is None:
                delattr(owner, name)
            else:
                setattr(owner, name, saved)

    def spread(key):
        v = [r.get(key, 0.0) for r in runs]
        return float(np.median(v)), float(min(v)), float(max(v))
    keys = ("wall", "stage shadow", "sweep", "prune", "connect", "wait")
    parts = {k: spread(k) for k in keys}
    st = stats.tolist()
    reprunes = st[2] / n_adds
    log(f"add() host breakdown over {n_adds} {len(rows)}-row adds at "
        f"{idx.n_nodes} rows (host clock, each stage's own time, median / "
        f"min / max ms; no synchronisation added but the closing one): "
        + "; ".join(f"{k} {a:.3f} / {b:.3f} / {c:.3f}"
                    for k, (a, b, c) in parts.items())
        + f"; the rest (the API, insert_batch_core's own ops) "
        f"{parts['wall'][0] - sum(parts[k][0] for k in keys[1:]):.3f} "
        f"(medians); host syncs inside the adds: {counted or 'none'}")
    log(f"add() wiring counters over the {n_adds} adds: {reprunes:.1f} "
        f"re-prunes a batch ({st[3]} pruned of {st[2]}), {st[1] / n_adds:.0f}"
        f" back-link ops and {st[0] / n_adds:.0f} chains a batch, longest "
        f"chain {st[6]}; peak device memory above what was allocated "
        f"before them: {peak['kernel']:.1f} MiB through the kernels, "
        f"{peak['twin']:.1f} MiB through the torch-op sweep")
    check(not counted, f"the adds synchronised with the card: {counted}")
    return dict(n_adds=n_adds, reprunes_a_batch=reprunes,
                **{f"{k.replace(' ', '_')}_ms": list(v)
                   for k, v in parts.items()},
                peak_mib=peak["kernel"], host_syncs=sum(counted.values()))


def phase_breakdown(torch, g, q, captured, profile_lib):
    """Where each kernel's time goes at phase 4b's shapes: the clock64()
    build of the same sources (pg_embedding_tpu_torch/graph_probe.py;
    never on the main path) gives each walk phase's cycles a block-step
    and each scan phase's cycles a set or a round."""
    from pg_embedding_tpu_torch import graph_probe
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    lib = profile_lib.result()
    for t in WALK_TS:
        kw = dict(ef=WALK_EF, cand_cap=WALK_EF, t=t, metric_value=L2)
        r = graph_probe.walk_phases(lib, g, q, **kw)
        smem, held, slots = cg._walk_layout(WALK_EF, WALK_EF, t, g.max_m,
                                            g.dims, None)
        log(f"beam_walk phases at T={t} (cycles a block-step, "
            f"{r['steps']:.2f} steps a block; setup + output: a block; "
            f"{smem} bytes of shared memory a block, tables of {held} and "
            f"{slots} slots): "
            f"{graph_probe.format_cycles(r['cycles'])}")
    for c, (*tensors, nn) in sorted(captured.items(), reverse=True):
        r = graph_probe.prune_phases(lib, tensors, nn)
        log(f"prune_scan phases at C={c}, nn={nn} "
            f"({graph_probe.prune_smem_bytes(c)} bytes of shared memory a "
            f"block; {r['pruned']} of "
            f"{r['sets']} sets pruned, {r['rounds']:.2f} rounds a pruned "
            f"set; cycles: init and write a set, search and reject a "
            f"round): "
            f"{graph_probe.format_cycles(r['cycles'])}")


def row_bytes(graph, kw):
    """Bytes of one neighbour's row as the walk reads it from ``kw``'s
    source: 4 D float32, 2 D bf16, D + 4 int8 and its scale, G PQ."""
    rows = kw.get("records", kw.get("qvectors", graph.vectors))
    scale = 4 if "pscales" in kw or "qscale" in kw else 0
    return rows.shape[-1] * rows.element_size() + scale


def variant_vs_twin(torch, graph, qs, kw, results, launches, *,
                    visited_slots=-1, ef=WALK_EF, t=GRAPH_T,
                    ring_launches=None):
    """One walk variant on a 1M index at T=8, ef=64 (the main path's
    shape; ``ef`` = cand_cap another width, ``t`` another T), with the
    walk's operands ``kw``: the kernel against the plain
    twin on the card on every query: recall@10 after finish_walk (vs the
    exact route over the stored rows) within 0.002 of the twin's, ids equal
    on >= 98% of queries, mean hops and dist_evals within 1%; then a call's
    time (CUDA events), the card's (a CUDA graph of 20 calls), the twin's
    and the bound.  ``launches``: the walk launches by variant of the API
    path just before, counted from 0 (walk_counts); the path must have
    launched this variant; ``ring_launches``: its launches of the float32
    records ring instance (ops/cuda_graph.RING_WALKS over that path), which
    must be positive where the rule places a ring and 0 elsewhere.  Float32 records must
    give the twin's ids, hops and dist_evals on every query.  Stores the
    numbers in ``results`` under the variant's name (with " T=t" where
    ``t`` is not T=8)."""
    from pg_embedding_tpu_torch.core import search as core_search
    from pg_embedding_tpu_torch.graph_probe import device_ms
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    from pg_embedding_tpu_torch.ops.cuda_bruteforce import fused_exact_search
    q = torch.as_tensor(qs, device=graph.vectors.device)
    walk = dict(ef=ef, metric_value=L2, cand_cap=ef, expand_width=t,
                visited_slots=visited_slots)
    records = kw.get("records")
    name = cg.walk_variant(graph.vectors.dtype,
                           None if records is None else records.dtype,
                           quantized="qvectors" in kw,
                           rotated="query_t" in kw,
                           visited_slots=visited_slots)
    fin = dict(metric_value=L2, hashed=visited_slots > 0,
               rerank="qvectors" in kw or (records is not None and
                                           records.dtype != torch.float32))
    check(launches.get(name, 0) > 0,
          f"the API path before launched no {name} walk: {launches}")
    with own_twin_calls():
        got = cg.beam_walk(graph, q, **walk, **kw)
        want = twin(core_search, graph, q, kw, walk)
        kd, ki = core_search.finish_walk(graph, q, *got[:2], **fin)
        pd, pi = core_search.finish_walk(graph, q, *want[:2], **fin)
    _, truth = fused_exact_search(q, graph.vectors, K,
                                  n_valid=graph.n_nodes)
    truth = truth.cpu().numpy()
    ki_np, pi_np = ki.cpu().numpy(), pi.cpu().numpy()
    rec_k = recall(ki_np, ki_np >= 0, truth)
    rec_p = recall(pi_np, pi_np >= 0, truth)
    same = (ki == pi).all(dim=1)
    n_diff, b = int((~same).sum()), len(ki)
    fin = torch.isfinite(pd) & same.unsqueeze(1)        # the hash set: inf
    err = float((kd[fin] - pd[fin]).abs().max()) if fin.any() else 0.0
    hk, hp = float(got[2].float().mean()), float(want[2].float().mean())
    ek, ep = float(got[3].float().mean()), float(want[3].float().mean())
    twin_kw = dict(kw)
    twin_kw["pcodes"] = twin_kw.pop("records", None)
    with own_twin_calls():
        kh, ke = cg.beam_walk(graph, q, **walk, **kw)[2:]
        dev_ms = device_ms(lambda: cg.beam_walk(graph, q, **walk, **kw))
        ms = median_ms(torch, lambda: cg.beam_walk(graph, q, **walk, **kw))
        plain_ms = median_ms(torch, lambda: core_search._search_batch(
            graph, q, **walk, **twin_kw))
    visited = None if visited_slots < 0 else (
        -(-graph.capacity // 32) if visited_slots == 0 else visited_slots,
        visited_slots)
    bound = walk_bound_ms(kh, ke, len(qs), graph.dims, t, graph.max_m,
                          row_bytes(graph, kw), visited)
    staging = staging_placement(cg, graph, q, kw, kh, ke, ef, t)
    if visited is not None:
        staging = visited_placement(torch, cg, graph, q, kh, ke, ef, t,
                                    visited_slots)
        # a set in shared memory moves none of its words through device
        # memory: its walk's bound is the bound without them; the bound
        # with them (the sets' yardstick while they lived in device
        # memory) is kept beside it
        staging[3]["bound_with_set_ms"] = bound
        staging = (staging[0] + f"; bound with the set's words "
                   f"{bound:.4f} ms", *staging[1:])
        if staging[1] == "shared":
            bound = staging[3]["bound_without_set_ms"]
    if ring_launches is not None:
        # the ring instance launched on the API path exactly where the
        # rule places a ring
        ringed = bool(staging) and staging[1] == "ring"
        check((ring_launches > 0) == ringed,
              f"{name} T={t}: the API path launched the ring instance "
              f"{ring_launches} times, the rule's placement "
              f"{staging[1] if staging else None}")
        if staging:
            staging[3]["ring_launches"] = ring_launches
            staging = (staging[0] + f"; {ring_launches} launches of the "
                       f"ring instance on its API path", *staging[1:])
    if staging and staging[1] in ("staged", "ring"):
        # the staged walk against the same launch reading its rows or
        # records, bit for bit
        from pg_embedding_tpu_torch import _kernels
        from pg_embedding_tpu_torch.graph_probe import walk as probe_walk
        unstaged = probe_walk(_kernels.load_library(), graph, q, ef=ef,
                              cand_cap=ef, t=t, metric_value=L2,
                              staged=False, **kw)
        same_walk = all(torch.equal(a, b) for a, b in zip(got, unstaged))
        check(same_walk, f"{name} T={t}: the staged walk differs from the "
              f"unstaged one")
        staging = (staging[0] + "; ids, distances, hops and dist_evals "
                   "equal to the unstaged walk's", *staging[1:])
    log(f"beam_walk {name} vs plain at {graph.n_nodes} rows, {b} queries, "
        f"ef={ef}, T={t} ({launches[name]} launches on its API path): "
        f"recall@10 {rec_k:.4f} / {rec_p:.4f} vs the exact route; ids "
        f"differ on {n_diff} of {b} queries; mean hops {hk:.2f} / {hp:.2f}, "
        f"dist_evals {ek:.1f} / {ep:.1f}; max_abs_err {err:.3g} where ids "
        f"agree; on {len(qs)} queries kernel {ms:.3f} ms a call, plain "
        f"{plain_ms:.3f} ms (median of 5, CUDA events), kernel "
        f"{dev_ms:.3f} ms on the card (a CUDA graph of 20 calls); bound "
        f"{bound:.4f} ms (bytes; {bound / dev_ms:.1%} of it reached)"
        + (f"; {staging[0]}" if staging else ""))
    check(abs(rec_k - rec_p) <= 0.002,
          f"{name}: walk recall {rec_k} vs the twin's {rec_p}")
    check(n_diff <= 0.02 * b, f"{name}: ids differ on {n_diff} queries")
    check(abs(hk - hp) <= 0.01 * hp and abs(ek - ep) <= 0.01 * ep,
          f"{name}: hops {hk} / {hp}, evals {ek} / {ep}")
    if records is not None and records.dtype == torch.float32:
        # the strict-parity walk: the twin's walk on every query
        same_walk = int((same & (got[2] == want[2])
                         & (got[3] == want[3])).sum())
        log(f"beam_walk {name} T={t}: ids, hops and dist_evals equal to the "
            f"twin's on {same_walk} of {b} queries")
        check(same_walk == b, f"{name} T={t}: the twin's walk on "
              f"{same_walk} of {b} queries")
    key = name if t == GRAPH_T else f"{name} T={t}"
    results[key] = dict(launches=launches[name], max_abs_err=err, ms=ms,
                        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by="bytes", recall=rec_k, plain_recall=rec_p)
    if staging:
        results[key].update(placement=staging[1], blocks_per_sm=staging[2])
        results[key].update(staging[3])


def staging_placement(cg, graph, q, kw, hops, evals, ef, t):
    """Where an int8 or bf16 records or rows walk, or a float32 records
    walk, at T = ``t``, ef = cand_cap = ``ef`` (a table instance) keeps
    each step's rows (ops/cuda_graph._records_place: staged in shared
    memory, float32 records in a ring of K rows, or read from the records
    or rows), and the blocks an SM holds of each placement's instance at
    its shared bytes, the runtime's occupancy (graph_probe.walk_blocks):
    the walk stages exactly where an SM then holds as many blocks as
    unstaged, up to the instance's register-bound residency
    (WALK_MIN_BLOCKS), and a ring of K + 1 rows would hold fewer (K is the
    most, where K is below T maxM).  Returns (the log line, with the
    layout's bytes, the instance's ptxas registers and spills
    (WALK_REPORTS) and, staged, the bytes the staging reads at most: each
    step's T popped records, or T maxM slots' rows, or min(K, the step's
    processed) ring rows, from the kernel's ``hops``; the placement
    ("staged", "ring", "records" or "rows"); the blocks an SM of the
    instance it takes; the kernels line's numbers: the instance's name,
    and a ring's rows), or None for the other sources."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.graph_probe import walk_blocks
    src = cg._check_walk_args(graph, q, ef, ef, t, L2, **kw)
    stage = src.stage
    if stage is None:
        return None
    staged = cg.records_staging(ef, ef, t, graph.max_m, graph.dims, stage)
    plain = cg._walk_smem_bytes(ef, ef, t, graph.max_m, graph.dims, None)
    rec, _ = cg._records_place(stage, t, graph.max_m, graph.dims, plain, 0)
    row = graph.dims * stage.itemsize
    ring = staged // row if stage.ring else 0
    if ring:
        rec = staged                    # the ring at the rule's K
    lib = _kernels.load_library()
    threads = cg._walk_threads(t, graph.max_m)
    blocks = {False: walk_blocks(lib, src.elem, False, t, graph.max_m,
                                 plain)}
    source = "rows" if stage.rows else "records"
    kept = min(blocks[False], cg.WALK_MIN_BLOCKS[threads])
    more = None
    if rec:
        blocks[True] = walk_blocks(lib, src.elem, True, t, graph.max_m,
                                   plain + rec)
        keeps = blocks[True] >= kept
        check(keeps == (staged > 0),
              f"{source} {src.rows.dtype} T={t}: staged {staged} B, but an "
              f"SM holds {blocks[True]} blocks staged against "
              f"{blocks[False]}")
    if ring and ring < stage.ring:
        # K is the most rows that keep the blocks: one more costs one
        more = walk_blocks(lib, src.elem, True, t, graph.max_m,
                           plain + rec + row)
        check(more < kept, f"records float32 T={t}: a ring of {ring + 1} "
              f"rows still holds {more} blocks an SM (K = {ring} is not "
              f"the most)")
    name = {1: "int8", 2: "bf16", 4: "float32"}[stage.itemsize]
    kind = " ring" if ring else " staged" if staged else ""
    inst = (f"beam_walk_kernel<{name}{kind} rows, dense, {threads} "
            f"threads>")
    spill, used = WALK_REPORTS[inst]
    regs = int(re.search(r"Used (\d+) registers", used)[1])
    if ring:
        # what the ring copies at most: min(K, the step's processed) rows
        # a step, so at most min(K hops, dist_evals) rows a query
        read = int((hops * ring).minimum(evals).sum()) * row
        where = "ring"
    else:
        # what one step copies at most: T records, or T maxM rows (and
        # scales)
        step = t * graph.max_m * (graph.dims * stage.itemsize
                                  + (4 if stage.scales else 0))
        read = int(hops.sum()) * step if staged else 0
        where = "staged" if staged else source
    how = (f"a ring of {ring} rows" if ring else "staged" if staged
           else f"read from the {source}")
    line = (f"placement {how} ({staged} staged bytes of {plain + staged} a block; {inst}: "
            f"{regs} registers, {spill}; {blocks[staged > 0]} blocks an SM"
            + (f", {blocks[False]} unstaged at {plain} B" if staged else
               f", {blocks[True]} staged at {plain + rec} B" if rec else "")
            + (f", {more} with a ring of {ring + 1} rows" if more is not None
               else "")
            + ", the runtime's occupancy)"
            + (f"; the staging reads at most {read:,} B "
               f"({read / PEAK_BYTES * 1e3:.4f} ms at the HBM rate)"
               if staged else ""))
    extra = dict(instance=inst)
    if ring:
        extra.update(ring_rows=ring, blocks_per_sm_one_row_more=more)
    return line, where, blocks[staged > 0], extra


def visited_placement(torch, cg, graph, q, hops, evals, ef, t,
                      visited_slots):
    """Where a float32 rows walk under the bitmap or hash set
    ``visited_slots`` at T = ``t``, ef = cand_cap = ``ef`` keeps the
    query's set (ops/cuda_graph._visited_place: the block's shared memory,
    or device memory, filled by the wrapper), and the blocks an SM holds
    of the set instance at its shared bytes with the set and without it,
    the runtime's occupancy (graph_probe.walk_blocks): a table instance
    keeps the set shared exactly where an SM then holds as many blocks as
    without it, up to WALK_MIN_BLOCKS.  Returns (the log line, with the
    instance's ptxas registers and spills, the wrapper's fill of a device
    set timed on its own (a CUDA graph of 20 calls; a shared set has none)
    and the walk's bound without the set's words; the placement; the
    blocks an SM of the instance at its shared bytes; the numbers for the
    kernels line)."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.graph_probe import device_ms, walk_blocks
    src = cg._check_walk_args(graph, q, ef, ef, t, L2,
                              visited_slots=visited_slots)
    plan = cg._walk_launch(graph, src, ef, ef, t, visited_slots)
    words = cg._visited_words(graph, visited_slots)
    plain = cg._walk_smem_bytes(ef, ef, t, graph.max_m, graph.dims, None)
    # the set's bytes where it fits the block, whatever an SM then holds
    room = cg._visited_place(words, plain, 0)[0]
    threads = cg._walk_threads(t, graph.max_m)
    lib = _kernels.load_library()
    blocks = {False: walk_blocks(lib, 0, False, t, graph.max_m, plain,
                                 dense=False)}
    kept = min(blocks[False], cg.WALK_MIN_BLOCKS[threads])
    an_sm = kept * (plain + room + cg.BLOCK_RESERVED)
    if room:
        blocks[True] = walk_blocks(lib, 0, False, t, graph.max_m,
                                   plain + room, dense=False)
        keeps = blocks[True] >= kept
        check((keeps and an_sm <= cg.SET_SM_SMEM) == plan.visited_shared,
              f"visited_slots={visited_slots} T={t}: shared "
              f"{plan.visited_shared}, but an SM holds {blocks[True]} blocks "
              f"with the set against {blocks[False]}, {an_sm} B of its "
              f"shared memory (at most {cg.SET_SM_SMEM})")
    check(plan.smem == plain + (room if plan.visited_shared else 0),
          f"visited_slots={visited_slots} T={t}: {plan.smem} bytes a block")
    inst = f"beam_walk_kernel<float32 rows, bitmap / hash, {threads} threads>"
    spill, used = WALK_REPORTS[inst]
    regs = int(re.search(r"Used (\d+) registers", used)[1])
    fill = None
    if not plan.visited_shared:
        fill = device_ms(lambda: cg._device_visited(len(q), words,
                                                    visited_slots, True,
                                                    q.device))
    bare = walk_bound_ms(hops, evals, len(q), graph.dims, t, graph.max_m)
    where = "shared" if plan.visited_shared else "device memory"
    line = (f"placement: the set ({words} words a query) in {where} "
            f"({plan.smem} bytes of shared memory a block; {inst}: {regs} "
            f"registers, {spill}; {blocks[plan.visited_shared]} blocks an SM"
            + (f", {blocks[False]} without the set at {plain} B"
               if plan.visited_shared else
               f", {blocks[True]} with it at {plain + room} B" if room
               else "") + ", the runtime's occupancy"
            + (f"; {an_sm:,} B of an SM's shared memory with the set, at "
               f"most {cg.SET_SM_SMEM:,} for a shared one" if room else "")
            + "); "
            + ("no device set, the blocks fill their own" if fill is None
               else f"the wrapper's fill of the device set {fill:.4f} ms "
                    f"on the card, on its own")
            + f"; bound without the set's words {bare:.4f} ms")
    return line, where, blocks[plan.visited_shared], dict(
        placement=where, blocks_per_sm=blocks[plan.visited_shared],
        fill_ms=fill, bound_without_set_ms=bare)


def walk_counts():
    """Set the walk kernel's launch counts by variant, and its ring
    instance's (cuda_graph.RING_WALKS), to 0 before a path's API calls;
    read them after it with dict(cuda_graph.WALK_VARIANTS) and
    cuda_graph.RING_WALKS."""
    from pg_embedding_tpu_torch.ops import cuda_graph
    cuda_graph.WALK_VARIANTS.clear()
    cuda_graph.RING_WALKS = 0
    return cuda_graph.WALK_VARIANTS


def serving_variants(torch, idx, qs, results):
    """Quantized and packed walks on the 1M index at T=8 through the API:
    QPS and recall@10 against the exact route, each within 0.005 of the
    plain walk's recall; float32 records must give the plain walk's ids and
    order; each variant's kernel against its plain twin (variant_vs_twin;
    the int8 and bf16 records walks also at API_T);
    then the bitmap and hash visited sets: the dense walk's ids through the
    API, and each kernel against its twin.  Each variant's launches are
    counted over its own API calls."""
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
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
        counts = walk_counts()
        t0 = time.time()
        _, ids = idx.search_ids(qs)            # builds the shadow/records
        torch.cuda.synchronize()
        first_s = time.time() - t0
        t0 = time.time()
        for _ in range(reps):
            _, gl, gv = idx.search(qs, K, mode="graph")
        qps = reps * len(qs) / (time.time() - t0)
        launches = dict(counts)
        ring = cg.RING_WALKS
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
        if idx.packed_traversal:
            kw = dict(records=idx._pcodes)
            if idx._pscales is not None:
                kw["pscales"] = idx._pscales
        else:
            kw = dict(qvectors=idx._qvec, qscale=idx._qscale)
        variant_vs_twin(torch, idx.graph, qs, kw, results, launches,
                        ring_launches=ring)
        if name in RECORDS_AT_API_T:
            # the API's default search_expand_width: the int8 rows and
            # each records walk at T=4 too (staged at every type, float32
            # records through their ring), its launches counted over one
            # API call
            idx.search_expand_width = API_T
            counts = walk_counts()
            idx.search_ids(qs)
            variant_vs_twin(torch, idx.graph, qs, kw, results, dict(counts),
                            t=API_T, ring_launches=cg.RING_WALKS)
            idx.search_expand_width = GRAPH_T
        idx.quantized_traversal = idx.packed_traversal = False
    log("packed float32 walk: ids and order equal the plain walk's on all "
        f"{len(qs)} queries")
    for mode, slots in WALK_VISITED.items():
        idx.visited_mode = mode
        check(idx._visited_slots(idx.config.ef_search) == slots,
              f"visited_mode={mode!r}: {slots} slots expected")
        counts = walk_counts()
        _, ids = idx.search_ids(qs)
        _, gl, gv = idx.search(qs, K, mode="graph")
        launches = dict(counts)
        idx.visited_mode = "dense"
        rec = recall(gl, gv, el)
        same = float((ids == plain_ids).all(axis=1).mean())
        log(f"visited_mode={mode!r}: recall@10 {rec:.4f} vs the exact "
            f"route; the dense walk's ef ids on {same:.4f} of the queries")
        # the bitmap is exact: the dense walk's ids; the hash set loses
        # entries to overwrites and re-expands their nodes (a different
        # walk, held to its twin below)
        check(mode == "hash" or same == 1.0,
              f"visited_mode={mode!r} ids differ from the dense walk's")
        variant_vs_twin(torch, idx.graph, qs, {}, results, launches,
                        visited_slots=slots)
        # the API's default search_expand_width, its launches counted over
        # one API call
        idx.visited_mode, idx.search_expand_width = mode, API_T
        counts = walk_counts()
        idx.search_ids(qs)
        launches = dict(counts)
        idx.visited_mode, idx.search_expand_width = "dense", GRAPH_T
        variant_vs_twin(torch, idx.graph, qs, {}, results, launches,
                        visited_slots=slots, t=API_T)


def wide_queue_phase(torch, idx, qs, integer_launches):
    """A filtered graph search on the 1M index that widens past 4096:
    ef_search 40 doubles to 5120 (7 widenings, 8 walks, all launches of
    the kernel, none of the twin, the four past the table instances' 320
    through the wide instances), 64 queries allowed
    only 0.2% of the rows, at random (2,000 at 1M).  Every returned label
    is allowed, and the walk's answers are the masked exact route's
    nearest (>= 0.9 of them).  Then each walk of that ladder (WIDENING_EFS,
    cand_cap = ef, unfiltered) timed on the card on the same 64 queries;
    the widest against its twin (variant_vs_twin at ef 5120) and timed at B
    = 1024 beside its bound.  Returns the widest walk's numbers: the
    launches those of the widening search's wide walks (4), then the wide
    instances' launches by phase (``integer_launches``: integer_walks' wide
    cases)."""
    from pg_embedding_tpu_torch.core import search as core_search
    from pg_embedding_tpu_torch.graph_probe import device_ms
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    n, g = idx.n_nodes, idx.graph
    where = np.zeros(n, bool)
    where[np.random.default_rng(SEED + 9).choice(n, n // 500,
                                                 replace=False)] = True
    ef_search = idx.config.ef_search
    idx.set_ef_search(40)
    plain = core_search.PLAIN_WALKS_ON_CARD
    widenings = idx.counters["n_widenings"]
    counts = walk_counts()
    wide0 = cg.WIDE_WALKS
    t0 = time.time()
    _, gl, gv = idx.search(qs[:64], K, mode="graph", where=where)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(counts)
    search_wide = cg.WIDE_WALKS - wide0
    idx.set_ef_search(ef_search)
    widened = idx.counters["n_widenings"] - widenings
    _, el, ev = idx.search(qs[:64], K, mode="exact", where=where)
    found = int(gv.sum())
    hit = sum(len(set(gl[i][gv[i]].tolist()) & set(el[i][ev[i]].tolist()))
              for i in range(64))
    log(f"widening past 4096: a filtered graph search (64 queries, "
        f"{n // 500} allowed rows) from ef_search 40 widened {widened} "
        f"times to 5120 in {wall:.3f} s; walk launches {launches}, "
        f"{search_wide} of them through the wide instances; {found} "
        f"results, {hit / max(found, 1):.4f} of them among the masked "
        f"exact route's {K}")
    check(widened == 7, f"widened {widened} times, not 40 -> 5120")
    check(launches == {"rows f32, dense": 8},
          f"the widening's walks: {launches}")
    check(search_wide == sum(ef > cg.MAX_WALK_QUEUE for ef in WIDENING_EFS),
          f"the widening ran {search_wide} wide walks")
    check(core_search.PLAIN_WALKS_ON_CARD == plain,
          "the widening ran a plain walk on the card")
    allowed = np.nonzero(where)[0].astype(np.uint64)
    check(bool(np.isin(gl[gv], allowed).all()),
          "the widening returned a row the filter excludes")
    check(found > 0 and hit >= 0.9 * found,
          f"the widened walk's results: {hit} of {found} among the exact "
          f"route's")
    q64 = torch.as_tensor(qs[:64], device=g.vectors.device)
    t = idx.search_expand_width
    ladder = {}
    for ef in WIDENING_EFS:
        kw = dict(ef=ef, metric_value=L2, cand_cap=ef, expand_width=t)
        ladder[ef] = device_ms(lambda: cg.beam_walk(g, q64, **kw))
    log(f"the widening's walks on the card (64 queries, T={t}, cand_cap = "
        f"ef; a CUDA graph of 20 calls each): "
        + ", ".join(f"ef {ef} {ms:.3f} ms" for ef, ms in ladder.items())
        + f"; {sum(ladder.values()):.3f} ms in all")
    wide = {}
    wide0 = cg.WIDE_WALKS
    variant_vs_twin(torch, g, qs[:64], {}, wide, launches, ef=5120)
    twin_wide = cg.WIDE_WALKS - wide0
    q = torch.as_tensor(qs, device=g.vectors.device)
    kw = dict(ef=5120, metric_value=L2, cand_cap=5120, expand_width=GRAPH_T)
    wide0 = cg.WIDE_WALKS
    _, _, kh, ke = cg.beam_walk(g, q, **kw)
    big_ms = device_ms(lambda: cg.beam_walk(g, q, **kw))
    big_wide = cg.WIDE_WALKS - wide0
    big_bound = walk_bound_ms(kh, ke, len(qs), g.dims, GRAPH_T, g.max_m)
    log(f"beam_walk rows f32, dense at ef = cand_cap = 5120, T={GRAPH_T}, "
        f"{len(qs)} queries: {big_ms:.3f} ms on the card (a CUDA graph of "
        f"20 calls), mean hops {float(kh.float().mean()):.2f}, dist_evals "
        f"{float(ke.float().mean()):.1f}; bound {big_bound:.4f} ms (bytes; "
        f"{big_bound / big_ms:.1%} of it reached)")
    out = wide["rows f32, dense"]
    out.update(launches=search_wide, launches_by_phase={
        "the widening search": search_wide,
        "integer checks (every row source and visited set)":
            integer_launches,
        "the 1M twin check and its timing (B = 64)": twin_wide,
        "timed at B = 1024": big_wide},
        ladder_device_ms={str(ef): ms for ef, ms in ladder.items()},
        b1024_device_ms=big_ms, b1024_bound_ms=big_bound)
    return out


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
    (two launches of 751 at k=1500, both on the mma.sync instance: the
    rule keeps pages off the Hopper one) and answers what ops/bruteforce's
    exact_search answers on the same rows: ids except float64 near-ties,
    distances to rtol 1e-5.  Returns the launch counts of that path (every
    count set to 0 just before it): the kernels line's for
    bruteforce_topk."""
    from pg_embedding_tpu_torch.ops.bruteforce import exact_search
    check(np.array_equal(idx.labels, np.arange(idx.n_nodes)),
          "labels are node ids")
    reset_launches()
    t0 = time.time()
    d, l, v = idx.search(qs[:64], 1500)                # auto -> exact route
    wide_s = time.time() - t0
    launches = launch_counts()
    pages = launches["bruteforce_topk"]
    check(pages == 2 and sum(launches.values()) == 2,
          f"k=1500 took {launches} kernel launches, not 2 mma.sync pages")
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
    return launches


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


def l1_oracle(torch, qs, rows, k, chunk=65_536):
    """The k least float64 Manhattan distances and their ids from each
    query to ``rows`` (torch.cdist in float64, a chunk of rows at a time,
    ties by the lower id)."""
    q = qs.double()
    best_d = torch.full((len(q), k), float("inf"), dtype=torch.float64,
                        device=q.device)
    best_i = torch.full((len(q), k), -1, dtype=torch.int64, device=q.device)
    for start in range(0, len(rows), chunk):
        d = torch.cdist(q, rows[start:start + chunk].double(), p=1.0)
        ids = torch.arange(start, start + d.shape[1], device=q.device)
        d = torch.cat([best_d, d], 1)
        i = torch.cat([best_i, ids.expand(len(q), -1)], 1)
        order = torch.sort(d, dim=1, stable=True).indices[:, :k]
        best_d, best_i = d.gather(1, order), i.gather(1, order)
    return best_d, best_i


def manhattan_phase(torch, cb, HnswConfig, HnswIndex, dev, pts, qs,
                    l2_build_s):
    """A Manhattan index of config 1's shape (the main path's rows, m=16,
    efc=64, the default exact8 candidates) built on the card, every launch
    count set to 0 just before the build and read after: the build's sweep
    is one bruteforce_topk_q8_l1 launch a batch past the first and no
    torch-op loop; its exact route (one bruteforce_topk_l1 launch) against
    a float64 oracle over every row (distances rtol 1e-5, ids but float64
    near-ties) and against its twin on all the queries; its graph route's
    recall@10 against its own exact route, within 0.002 of
    EARLIER_L1_RECALL; its build's seconds beside the L2 index's
    (``l2_build_s``); then the exact route
    at 1M, B=1024, k=10 over float32 rows and their bf16 values (one
    bruteforce_topk_bf16_l1 launch, counted on the same path), each timed
    beside its twin, its bound (2 B N D float32 operations at 67 TFLOP/s),
    its FADD ceiling (l1_ceiling_ms) and the library call (torch.cdist(p=1)
    + torch.topk over one 1M chunk).  Returns (the launches on this path,
    the kernels line's numbers of bruteforce_topk_l1 and _bf16_l1)."""
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.graph_probe import device_ms
    reset_launches()
    idx = HnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                               ef_search=64, metric="manhattan"),
                    device=dev, search_expand_width=GRAPH_T)
    sweeps = core_build.PLAIN_SWEEPS_ON_CARD
    t0 = time.time()
    idx.build(pts)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    batches = len(core_build.build_schedule(len(pts), idx.max_insert_batch))
    built = launch_counts()
    check(built["bruteforce_topk_q8_l1"] == batches - 1
          and core_build.PLAIN_SWEEPS_ON_CARD == sweeps,
          f"the Manhattan build swept {built} over {batches} batches "
          f"(torch-op loops {core_build.PLAIN_SWEEPS_ON_CARD - sweeps})")
    de, le, ve = idx.exact_search(qs, K)
    dg, lg, vg = idx.search(qs, K, mode="graph")
    ran = launch_counts()
    check(ran["bruteforce_topk_l1"] == 1, f"the exact route launched {ran}")
    rec = recall(lg, vg, le)
    rows = idx.graph.vectors[:idx.n_nodes]
    q = torch.as_tensor(qs, device=dev)
    od, oi = l1_oracle(torch, q, rows, K)
    got = (torch.as_tensor(de, device=dev), torch.as_tensor(
        le.astype(np.int64), device=dev))
    err, n_diff = compare(torch, got, (od.float(), oi), q, rows, MANHATTAN,
                          idx.n_nodes, None)
    with own_twin_calls():
        twin = cb._bruteforce_topk_plain(q, rows, K, MANHATTAN, idx.n_nodes)
        t_err, t_diff = compare(torch, (got[0], got[1].int()), twin, q, rows,
                                MANHATTAN, idx.n_nodes, None)
    log(f"Manhattan index (1M x {DIMS}-d, m=16, efc=64, exact8) built on the "
        f"card in {build_s:.1f} s: {built['bruteforce_topk_q8_l1']} "
        f"bruteforce_topk_q8_l1 launches over {batches} batches, no torch-op "
        f"sweep; exact route vs a float64 oracle on {len(qs)} queries: "
        f"max_abs_err {err:.3g}, {n_diff} near-tie id swaps; vs its twin "
        f"max_abs_err {t_err:.3g}, {t_diff} near-tie id swaps; graph route "
        f"(T={GRAPH_T}, ef 64) recall@10 vs its exact route {rec:.4f} "
        f"({EARLIER_L1_RECALL} before the register tile)")
    log(f"1M builds on the card: Manhattan {build_s:.1f} s, L2 (the main "
        f"path's) {l2_build_s:.1f} s")
    # the earlier figure is the 1M index's (--n cuts the rows)
    check(len(pts) != 1_000_000 or abs(rec - EARLIER_L1_RECALL) <= 0.002,
          f"the Manhattan graph's recall@10 {rec:.4f} is not within 0.002 "
          f"of its earlier {EARLIER_L1_RECALL}")
    out = {}
    n, d = rows.shape
    for name, corpus in (("bruteforce_topk_l1", rows),
                         ("bruteforce_topk_bf16_l1",
                          rows.to(torch.bfloat16))):
        if corpus.dtype == torch.bfloat16:
            before = cb.LAUNCHES[name]
            cb.fused_exact_search(q, corpus, K, "manhattan")
            check(cb.LAUNCHES[name] == before + 1,
                  f"the bf16 exact route launched {cb.LAUNCHES}")
        dense = corpus.float()

        def kernel():
            return cb.bruteforce_topk(q, corpus, K, MANHATTAN, n)

        def plain():
            return cb._bruteforce_topk_plain(q, corpus, K, MANHATTAN, n)
        with own_twin_calls():
            k_err, k_diff = compare(torch, kernel(), plain(), q, dense,
                                    MANHATTAN, n, None)
            ms = median_ms(torch, kernel)
            dev_ms = device_ms(kernel)
            plain_ms = median_ms(torch, plain, 3)
        lib_ms = median_ms(torch, lambda: torch.topk(
            torch.cdist(q, dense, p=1.0), K, dim=1, largest=False), 3)
        bound, bound_by = l1_bound_ms(len(q), n, d)
        ceiling = l1_ceiling_ms(torch, len(q), n, d)
        log(f"{name} (the exact route, Manhattan) at {n} x {d}-d, B="
            f"{len(q)}, k={K}: vs its twin max_abs_err {k_err:.3g}, {k_diff} "
            f"near-tie id swaps; {ms:.3f} ms a call, {dev_ms:.3f} ms on the "
            f"card; bound {bound:.3f} ms ({bound_by}; {bound / dev_ms:.1%} of "
            f"it reached); FADD ceiling {ceiling:.3f} ms "
            f"({ceiling / dev_ms:.1%} of it reached); twin {plain_ms:.3f} ms; "
            f"library (torch.cdist + "
            f"torch.topk) {lib_ms:.3f} ms")
        out[name] = dict(max_abs_err=max(k_err, err if corpus is rows else 0),
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
                         ceiling_ms=ceiling)
        del dense
    launches = launch_counts()
    del idx
    return launches, out


def pq_sweep_phase(torch, idx, qs, el):
    """tune_sweep_pool(0.95) on 256 queries, then sweep_pq on all: recall@10
    >= 0.95 vs the exact route, distances equal to a float64 recompute;
    every launch count set to 0 just before the tuner and read after the
    searches (the PQ kernel's own path: one call a search, beside the
    tuner's one exact-route oracle).  Returns the
    kernels line's numbers of bruteforce_topk_pq (pq_pool_timing's and
    its launches)."""
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
    reset_launches()
    t0 = time.time()
    res = idx.tune_sweep_pool(qs[:256], 0.95)
    tune_s = time.time() - t0
    idx.search(qs, K, mode="sweep_pq")
    reps = 2
    t0 = time.time()
    for _ in range(reps):
        d, l, v = idx.search(qs, K, mode="sweep_pq")
    qps = reps * len(qs) / (time.time() - t0)
    ran = dict(cb.LAUNCHES)
    log(f"sweep_pq's path (the tuner's exact oracle, its probes and "
        f"{reps + 1} searches): launches {ran}")
    check(ran["bruteforce_topk_pq"] > reps + 1
          and ran["bruteforce_topk_wgmma"] == 1
          and sum(ran.values()) == ran["bruteforce_topk_pq"] + 1,
          f"sweep_pq's path launched {ran}")
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
    return dict(launches=ran["bruteforce_topk_pq"],
                **pq_pool_timing(torch, idx, q))


def pq_kernel_call(torch, q, codes, table, n, dead, pool, metric):
    """One call of bruteforce_topk_pq as pq_topk makes it (its launch
    shape and buffers, the bound refilled with +inf) but for the overflow
    check, which synchronises: a call a CUDA graph can capture, for its
    time on the card.  Returns (call, counts, cap) for the caller to check
    that no segment overflowed."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
    lib = _kernels.load_library()
    b, d = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, rank, cap, _ = cb._pq_launch_shape(b, n, pool, sms)
    buf = torch.empty((b, splits, cap, 2), dtype=torch.int32, device=q.device)
    counts = torch.empty((b, splits), dtype=torch.int32, device=q.device)
    bound = torch.full((b, splits), float("inf"), device=q.device)
    out_d = torch.empty((b, pool), device=q.device)
    out_i = torch.empty((b, pool), dtype=torch.int32, device=q.device)

    def call():
        bound.fill_(float("inf"))
        err = lib.bruteforce_topk_pq(
            q.data_ptr(), codes.data_ptr(), table.data_ptr(),
            None if dead is None else dead.data_ptr(), b, n, d,
            codes.shape[1], pool, metric, splits, cb.PQ_SMEM, buf.data_ptr(),
            cap, counts.data_ptr(), bound.data_ptr() if rank else None, rank,
            out_d.data_ptr(), out_i.data_ptr(), None, None, None, None,
            torch.cuda.current_stream().cuda_stream)
        _kernels.check(lib, err, "bruteforce_topk_pq")
    return call, counts, cap


def pq_pool_timing(torch, idx, q):
    """ops/pq_sweep._pq_pool (the JAX package's _pq_pool_impl: one call
    of bruteforce_topk_pq) at this phase's shape, the tuned pool over every
    live row's codes, all the queries: against its twin _pq_pool_plain on
    the card (ids equal on >= 99.9% of slots, every other slot a float64
    near-tie over the decoded bf16 rows: compare's rule; distances rtol
    1e-5); a call's time (CUDA events, median of 5), the card's (a CUDA
    graph of 20 calls of the kernel's C entry, pq_kernel_call: the
    wrapper's overflow check synchronises), the twin's, library_ms
    (pq_decode of every live row to bf16, then torch.matmul in float32 +
    torch.topk to the pool over
    one 1,048,576-row chunk; the port never calls it) and the bound: the
    decoded rows are bf16 values, so the products as products_s says, or
    the bytes (the codes, the codebook, the queries, the pool) at the HBM
    rate, whichever is larger.  Then the pools PQ_POOLS, each against the
    twin (every slot whose id differs a float64 near-tie, compare's rule;
    the share of equal ids printed: deep pools over this clustered data
    hold many near-ties, and past pool 256 the share falls under 0.999
    whichever of two float32 sums is the closer to float64) and timed
    beside it and the library call.  Returns the kernels line's
    numbers."""
    from pg_embedding_tpu_torch.graph_probe import device_ms
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
    from pg_embedding_tpu_torch.ops.distance import _matmul
    from pg_embedding_tpu_torch.ops.pq import pq_decode
    from pg_embedding_tpu_torch.ops.pq_sweep import _pq_pool, _pq_pool_plain
    codes = idx._ensure_pq_codes()
    book, rot = idx._pq_codebook, idx._pq_rot
    n, groups = idx.n_nodes, codes.shape[1]
    pool = 1 << (max(int(idx.pq_sweep_pool), K) - 1).bit_length()
    dead = idx.graph.deleted
    kw = dict(pool=pool, metric_value=L2, chunk=16384)

    def call():
        return _pq_pool(q, codes, book, rot, n, dead, **kw)

    def twin():
        return _pq_pool_plain(q, codes, book, rot, n, dead, **kw)

    def library():
        rows = pq_decode(codes[:n], book).to(torch.bfloat16).float()
        dist = torch.matmul(q, rows.T)
        torch.topk(dist, pool, dim=1, largest=False, sorted=False)
    with own_twin_calls():
        got, want = call(), twin()
        torch.cuda.synchronize()
        rows = pq_decode(codes[:n], book).to(torch.bfloat16).float()
        qr = q if rot is None else _matmul(q, rot)
        errs = f64_errors(torch, got, want, qr, rows, L2)
        log(f"_pq_pool at the tuned pool {pool}: {errs}")
        err, n_diff = compare(torch, got, want, qr, rows, L2, n, dead)
        del rows
        same = 1.0 - n_diff / got[1].numel()
        ms = median_ms(torch, call)
        qr = q if rot is None else _matmul(q, rot)
        raw, counts, cap = pq_kernel_call(torch, qr.contiguous(), codes,
                                          cb.pq_table(book), n, dead, pool,
                                          L2)
        dev_ms = device_ms(raw)
        check(int(counts.max()) <= cap,
              f"a segment overflowed in the timed calls ({int(counts.max())}"
              f" > {cap})")
        plain_ms = median_ms(torch, twin, 3)
    lib_ms = median_ms(torch, library)
    b, d = q.shape
    ops_ms = products_s(b, n, d, True) * 1e3
    nbytes = (n * groups + book.numel() * 4 + b * d * 4 + b * pool * 8)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound, bound_by = max(ops_ms, bytes_ms), ("operations" if ops_ms
                                             >= bytes_ms else "bytes")
    log(f"_pq_pool (bruteforce_topk_pq) at {n} rows, G={groups}, B={b}, pool "
        f"{pool}: vs its twin ids equal on {same:.5f} of slots ({n_diff} "
        f"float64 near-ties), max_abs_err {err:.3g}; {ms:.3f} ms a call "
        f"(median of 5, CUDA events), {dev_ms:.3f} ms on the card (a CUDA "
        f"graph of 20 calls; {bound / dev_ms:.1%} of the bound); bound "
        f"{bound:.4f} ms ({bound_by}: operations {ops_ms:.4f} ms as bf16 "
        f"values, bytes {bytes_ms:.4f} ms); twin {plain_ms:.3f} ms; library "
        f"(pq_decode + torch.matmul + torch.topk) {lib_ms:.3f} ms")
    check(same >= 0.999, f"_pq_pool ids equal on {same} of slots")
    # the pools the tuner can choose, each against the twin and timed
    pools = {}
    for size in PQ_POOLS:
        pkw = dict(kw, pool=size)
        with own_twin_calls():
            got = _pq_pool(q, codes, book, rot, n, dead, **pkw)
            want = _pq_pool_plain(q, codes, book, rot, n, dead, **pkw)
            torch.cuda.synchronize()
            rows = pq_decode(codes[:n], book).to(torch.bfloat16).float()
            qr = q if rot is None else _matmul(q, rot)
            p_errs = f64_errors(torch, got, want, qr, rows, L2)
            log(f"_pq_pool at pool {size}: {p_errs}")
            p_err, p_diff = compare(torch, got, want, qr, rows, L2, n, dead)
            del rows
            p_ms = median_ms(torch, lambda: _pq_pool(q, codes, book, rot, n,
                                                     dead, **pkw))
            p_plain = median_ms(torch, lambda: _pq_pool_plain(
                q, codes, book, rot, n, dead, **pkw), 3)

        def lib_call():
            rows = pq_decode(codes[:n], book).to(torch.bfloat16).float()
            torch.topk(torch.matmul(q, rows.T), size, dim=1, largest=False,
                       sorted=False)
        p_lib = median_ms(torch, lib_call)
        p_same = 1.0 - p_diff / got[1].numel()
        pools[size] = dict(ms=p_ms, plain_ms=p_plain, library_ms=p_lib,
                           max_abs_err=p_err, ids_equal=p_same)
        log(f"_pq_pool at pool {size}: vs its twin ids equal on "
            f"{p_same:.5f} of slots ({p_diff} float64 near-ties), "
            f"max_abs_err {p_err:.3g}; {p_ms:.3f} ms a call (median of 5, "
            f"CUDA events); bound {bound:.4f} ms; twin {p_plain:.3f} ms; "
            f"library {p_lib:.3f} ms")
    # Manhattan, the kernel's CUDA-core sum, on the first 128 queries
    mkw = dict(kw, metric_value=MANHATTAN)
    qm = q[:128]
    with own_twin_calls():
        got = _pq_pool(qm, codes, book, rot, n, dead, **mkw)
        want = _pq_pool_plain(qm, codes, book, rot, n, dead, **mkw)
        rows = pq_decode(codes[:n], book).to(torch.bfloat16).float()
        qr = qm if rot is None else _matmul(qm, rot)
        m_err, m_diff = compare(torch, got, want, qr, rows, MANHATTAN, n,
                                dead)
        del rows
        m_same = 1.0 - m_diff / got[1].numel()
        m_ms = median_ms(torch, lambda: _pq_pool(qm, codes, book, rot, n,
                                                 dead, **mkw))
        m_plain = median_ms(torch, lambda: _pq_pool_plain(
            qm, codes, book, rot, n, dead, **mkw), 3)
    log(f"_pq_pool, Manhattan (bruteforce_topk_pq's CUDA-core sum), "
        f"{len(qm)} queries, pool {pool}: vs its twin ids equal on "
        f"{m_same:.5f} of slots ({m_diff} float64 near-ties), max_abs_err "
        f"{m_err:.3g}; {m_ms:.3f} ms a call, twin {m_plain:.3f} ms")
    check(m_same >= 0.999, f"Manhattan _pq_pool ids equal on {m_same}")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
                pools=pools, manhattan=dict(queries=len(qm), ms=m_ms,
                                            plain_ms=m_plain,
                                            ids_equal=m_same))


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


def pq_main(torch, idx, qs, results):
    """G=32 on the main index (bench.py's 1,000 centres): printed, not
    held; the PQ walk kernel against its twin; then the card against the
    CPU (codes and the walk)."""
    _, el, _ = idx.exact_search(qs, K)
    _, pl, pv = idx.search(qs, K, mode="graph")
    log(f"PQ on the main index (1,000 centres, ~1,000 rows each): plain "
        f"walk recall@10 {recall(pl, pv, el):.4f}")
    counts = walk_counts()
    pq_walk(torch, idx, qs, el, 32, False)
    variant_vs_twin(torch, idx.graph, qs, dict(
        records=idx._pcodes, pq_codebook=idx._pq_codebook), results,
        dict(counts))
    codes_card_vs_cpu(torch, idx)
    pq_walk_card_vs_cpu(torch, idx, qs)


def pq_serving_phase(torch, HnswConfig, HnswIndex, dev, n, n_queries, tmp,
                     results):
    """PQ where the JAX package measured it serving (bench_pq.py's
    50,000-centre recipe): G=16, OPQ G=32 (its walk kernel against its
    twin) and G=32 walks (G=32 held within 0.03 of the plain walk's
    recall), the tuned sweep, save -> load.  Returns the kernels line's
    numbers of bruteforce_topk_pq."""
    from pg_embedding_tpu_torch.ops.distance import _matmul
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
    counts = walk_counts()
    pq_walk(torch, idx, qs, el, 32, True)
    launches = dict(counts)
    q = torch.as_tensor(qs, device=dev)
    variant_vs_twin(torch, idx.graph, qs, dict(
        records=idx._pcodes, pq_codebook=idx._pq_codebook,
        query_t=_matmul(q, idx._pq_rot)), results, launches)
    rec = pq_walk(torch, idx, qs, el, 32, False)
    check(rec >= plain - 0.03,
          f"PQ G=32 walk recall {rec} vs the plain walk's {plain}")
    pq_pool = pq_sweep_phase(torch, idx, qs, el)
    pq_persistence(torch, HnswIndex, idx, qs, tmp)
    return pq_pool


def bf16_phase(torch, cb, idx, qs, results):
    """The one-way downcast, then the exact route through the bf16
    instantiation; returns its launch counts.  On every query the route must
    return the exact top-k of the rows it stores: a float64 oracle over the
    bf16 rows, with the kernel check's near-tie rule (a returned row within
    1e-5 relative of the oracle's k-th distance).  Its recall against the
    float32 route is printed only: bf16 rounding reorders near-ties.  Then
    the graph route over the bf16 rows (the walk kernel's bf16 rows) and
    that kernel against its twin."""
    n = idx.n_nodes
    check(np.array_equal(idx.labels, np.arange(n)), "labels are node ids")
    _, el, _ = idx.exact_search(qs, K)
    idx.downcast_corpus("bfloat16")
    reset_launches()
    _, bl, bv = idx.search(qs, K)                      # auto -> exact route
    launches = launch_counts()
    check(launches["bruteforce_topk_bf16_wgmma"] > 0,
          "search() on a bf16 corpus did not launch the bf16 Hopper kernel")
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
    # k past one launch: pages of the mma.sync bf16 instance, every row of
    # them live and once, ascending (the kernels line's launches for it)
    reset_launches()
    pd, pl, pv = idx.exact_search(qs[:64], 1500)
    paged = launch_counts()
    check(paged["bruteforce_topk_bf16"] == 2 and sum(paged.values()) == 2,
          f"bf16 k=1500 launched {paged}, not 2 mma.sync pages")
    check(bool(pv.all()) and all(len(set(r.tolist())) == 1500 for r in pl)
          and not np.isin(pl, torch.nonzero(dead).cpu().numpy()).any()
          and bool((np.diff(pd, axis=1) >= 0).all()),
          "bf16 k=1500: a gap, a repeated or deleted row, or out of order")
    log(f"bf16 exact_search(k=1500) on 64 queries: {paged['bruteforce_topk_bf16']}"
        f" pages of the mma.sync instance, every row live, once, ascending")
    packed, idx.packed_traversal = idx.packed_traversal, False
    t_was = idx.search_expand_width
    # the graph's T, then the API's default (staged at T=4 only: bf16 rows
    # at T=8 would hold 2 blocks an SM of 4)
    for t in (GRAPH_T, API_T):
        idx.search_expand_width = t
        counts = walk_counts()
        _, gl, gv = idx.search(qs, K, mode="graph")
        walks = dict(counts)
        log(f"search(mode='graph') over the bf16 rows, T={t}: recall@10 "
            f"{recall(gl, gv, oracle):.4f} vs the float64 oracle over them")
        variant_vs_twin(torch, idx.graph, qs, {}, results, walks, t=t)
    idx.search_expand_width = t_was
    idx.packed_traversal = packed
    return launches, paged


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


def sharded_phase(torch, cb, HnswConfig, ShardedHnswIndex, dev, pts, qs,
                  single, tmp):
    """The sharded index on the main index's rows and queries: S shards on
    the card, built from scratch, then both routes beside the single
    index's figures (``single``, taken by main_path before its deletes).
    Returns the launch counts of the phase's own run of the path (build,
    search() in auto mode, the timed calls, the deletes, save -> load)."""
    from pg_embedding_tpu_torch.utils.profiling import Timer
    n, s = len(pts), SHARDS
    reset_launches()
    idx = ShardedHnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                                      ef_search=64), s, device=dev,
                           max_insert_batch=SHARD_BATCH,
                           search_expand_width=GRAPH_T)
    timer = Timer()
    with timer.phase("build", torch.empty(0, device=dev)):
        idx.build(pts)
    build_s = timer.seconds["build"]
    counts = idx.shard_counts
    check(idx.n_nodes == n and counts.max() - counts.min() <= 1,
          f"shard counts {counts}")
    viol = idx.check_integrity(raise_on_error=False)
    check(not any(viol.values()), f"sharded integrity {viol}")
    log(f"sharded build: {n} vectors into {s} shards (capacity "
        f"{idx.capacity_per_shard} each, batches of {idx.max_insert_batch}) "
        f"in {build_s:.1f} s = {n / build_s:.0f} vec/s (single index: "
        f"{single['build_s']:.1f} s = {n / single['build_s']:.0f} vec/s); "
        f"integrity clean")

    before = cb.LAUNCHES["bruteforce_topk_wgmma"]
    d, l, v = idx.search(qs, K)                        # auto -> exact route
    per_call = cb.LAUNCHES["bruteforce_topk_wgmma"] - before
    check(per_call == s, f"one sharded exact call launched the kernel "
          f"{per_call} times, not once per shard ({s})")
    check(idx.counters["n_exact_routed"] == len(qs), "auto did not route "
          "to the exact sweep")
    check(d.shape == (len(qs), K) and bool(np.isfinite(d).all())
          and bool(v.all()), "sharded exact results shape/finite")
    # the same rows as the single index, so the same answer: labels are
    # insert positions in both; a differing one must be a float64 near-tie
    want = single["exact_labels"]
    rows, cols = np.nonzero(l != want)
    if len(rows):
        full = torch.as_tensor(pts, device=dev)
        q = torch.as_tensor(qs[rows], device=dev).double()
        a = (full[l[rows, cols].astype(np.int64)].double() - q).norm(dim=1)
        b = (full[want[rows, cols].astype(np.int64)].double() - q).norm(dim=1)
        check(bool(((a - b).abs() <= 1e-5 * b + 1e-6).all()),
              "sharded exact label differs from the single index's at a "
              "rank that is not a near-tie")

    reps = 5
    t0 = time.time()
    for _ in range(reps):
        el = idx.exact_search(qs, K)[1]
    exact_qps = reps * len(qs) / (time.time() - t0)
    reps = 3
    idx.search(qs, K, mode="graph")
    t0 = time.time()
    for _ in range(reps):
        _, gl, gv = idx.search(qs, K, mode="graph")
    graph_qps = reps * len(qs) / (time.time() - t0)
    rec = recall(gl, gv, el)
    log(f"sharded exact_search: {exact_qps:.0f} QPS, {per_call} kernel "
        f"launches a call, labels equal the single index's except "
        f"{len(rows)} float64 near-ties of {want.size} (single index: "
        f"{single['exact_qps']:.0f} QPS); sharded search(mode='graph', "
        f"T={GRAPH_T}, ef={idx.config.ef_search}): {graph_qps:.0f} QPS at "
        f"recall@10 {rec:.4f} vs the exact route (single index: "
        f"{single['graph_qps']:.0f} QPS at {single['recall']:.4f})")
    check(rec >= 0.90, f"sharded graph recall {rec} < 0.90")

    dead = np.random.default_rng(SEED + 5).choice(
        n, 1_000, replace=False).astype(np.uint64)
    check(idx.delete(dead) == len(dead), "sharded delete count")
    for mode in ("exact", "graph"):
        _, dl, dv = idx.search(qs, K, mode=mode)
        check(not np.isin(dl[dv], dead).any(),
              f"sharded: deleted label from {mode}")
        check(bool(dv.all()), f"sharded {mode}: fewer than k live results")

    path = os.path.join(tmp, "sharded.npz")
    t0 = time.time()
    idx.save(path, per_shard=True)
    save_s = time.time() - t0
    files = [f for f in os.listdir(tmp) if f.startswith("sharded.")]
    size = sum(os.path.getsize(os.path.join(tmp, f)) for f in files)
    t0 = time.time()
    back = ShardedHnswIndex.load(path, device=dev)
    back.search_expand_width = idx.search_expand_width     # not persisted
    torch.cuda.synchronize()
    load_s = time.time() - t0
    check(back.n_shards == s and back.vacuum()["num_dead"] == len(dead),
          "loaded sharded index: shards / tombstones")
    kept = answers(idx, qs)
    same_answers(kept, answers(back, qs), "loaded sharded index")
    launches = launch_counts()
    shard_err, shard_swaps, k_units, p_units = shard_kernel_vs_plain(
        torch, cb, idx, qs, dev)
    log(f"sharded delete: {len(dead)} labels tombstoned, none returned by "
        f"either route; save(per_shard=True): {len(files)} files, "
        f"{size / 1e9:.3f} GB in {save_s:.1f} s; load onto the card "
        f"{load_s:.1f} s, both routes' labels equal; kernel launches of the "
        f"sharded phase: {launches}; the kernel vs its plain twin on every "
        f"shard's own rows (capacity {idx.capacity_per_shard}, n_valid and "
        f"tombstones as the exact route passes them): max_abs_err="
        f"{shard_err:.3g}, near-tie id swaps={shard_swaps}, within "
        f"{SHARD_UNITS} float32 roundings of the raw score (against float64 "
        f"the kernel is off by up to {k_units:.1f}, the plain twin "
        f"{p_units:.1f}); the per-shard exact call equals a float64 oracle "
        f"at rtol 1e-5")
    # the snapshot and its answers stay on disk for the two-rank phase
    np.savez(os.path.join(tmp, "phase9.npz"), graph=kept[0], exact=kept[1],
             dead=dead, qs=qs)
    return launches


def shard_kernel_vs_plain(torch, cb, idx, qs, dev):
    """The kernel against its plain twin with the arguments the sharded
    exact route gives it: each shard's view of the stacked rows, its count
    as n_valid, its tombstones, k_run = k + 2.  These rows' squared norms
    (~2,200) are ~10x their squared distances, so the raw scores carry
    the expansion's cancellation: the two are held within SHARD_UNITS
    float32 roundings of the score, and each one's distance from float64
    is measured in those roundings.  Then the whole per-shard call,
    fused_exact_search (kernel + exact rerank), against a float64 oracle
    at rtol 1e-5.  Returns (max abs distance error of the raw scores,
    near-tie id swaps, the kernel's and the plain twin's largest error
    against float64 in roundings) over the shards."""
    from pg_embedding_tpu_torch.config import Metric
    q = torch.as_tensor(qs, device=dev)
    qn = (q.double() ** 2).sum(1, keepdim=True)
    err, swaps, units = 0.0, 0, [0.0, 0.0]
    for i, graph in enumerate(idx._graphs):
        dead = idx._deleted[i]
        check(graph.vectors.shape[0] == idx.capacity_per_shard
              and bool(dead[: graph.n_nodes].any()),
              f"shard {i}: not the serving view, or no tombstone in it")
        args = (q, graph.vectors, K + 2, L2, graph.n_nodes, dead)
        got = cb.bruteforce_topk_paged(*args)
        want = cb._bruteforce_topk_plain(*args)
        torch.cuda.synchronize()
        e, n_diff = compare(torch, got, want, q, graph.vectors, L2,
                            graph.n_nodes, dead, cancel_units=SHARD_UNITS)
        err, swaps = max(err, e), swaps + n_diff
        for j, (dist, ids) in enumerate((got, want)):
            rows = graph.vectors[ids.long()].double()
            true = (rows - q.double().unsqueeze(1)).norm(dim=-1)
            unit = 2.0 ** -23 * (qn + (rows ** 2).sum(-1)) / (2 * true)
            units[j] = max(units[j],
                           float(((dist.double() - true).abs() / unit).max()))
        d, ids = cb.fused_exact_search(q, graph.vectors, K, Metric.L2,
                                       n_valid=graph.n_nodes, deleted=dead)
        d64 = torch.cdist(q.double(), graph.vectors.double())
        d64[:, graph.n_nodes:] = float("inf")
        d64[:, dead] = float("inf")
        kth = torch.topk(d64, K, largest=False).values
        own = d64.gather(1, ids.long())
        check(torch.allclose(d.double(), own, rtol=1e-5, atol=1e-6)
              and torch.allclose(own, kth, rtol=1e-5, atol=1e-6),
              f"shard {i}: the exact route against a float64 oracle")
        del d64
    return err, swaps, units[0], units[1]


def tuner_phase(idx, tmp):
    """tune_exact8_chunk on the main 1M index (its cache pointed at a temp
    dir, save=False): the tuner prints each chunk's ms per insert batch of
    the index's max_insert_batch rows; a chunk must be chosen.  The sweep
    kernel takes no chunk, so the times differ only by noise."""
    os.environ["PG_EMB_TUNE_DIR"] = tmp
    chunks = (262_144, 524_288, 1_048_576, 2_097_152)
    log(f"tune_exact8_chunk on {idx.n_nodes} rows, batches of "
        f"{idx.max_insert_batch}:")
    t0 = time.time()
    chunk = idx.tune_exact8_chunk(chunks=chunks, save=False, verbose=True)
    sys.stdout.flush()
    check(chunk in chunks and idx.exact8_chunk == chunk,
          f"tune_exact8_chunk chose {chunk}")
    log(f"tune_exact8_chunk chose {chunk} rows a chunk in "
        f"{time.time() - t0:.1f} s (on the card the sweep is one kernel "
        f"launch that takes no chunk: every width times the same sweep)")


def twin_build_phase(torch, HnswConfig, HnswIndex, dev, pts, qs):
    """The first TWIN_BUILD_ROWS rows built three times on the card:
    through the API (the sweep and wiring kernels: the build's sweep on
    the Hopper int8 instance by the rule), with core/build's sweep swapped
    for the torch-op loop (loop_pool) and its wiring for the plain twin
    (_connect_batch_plain), and with the route forced to the mma.sync int8
    instance (ops/cuda_bruteforce._wgmma_route refusing int8 rows), each
    swap made by the smoke inside own_twin_calls (no knob of the package).
    Against the first build: link rows >= 99.9% identical, graph recall@10
    (against each index's exact route) within 0.002 at T=8 (and, for the
    mma.sync build, at T=4 too)."""
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
    rows = pts[:TWIN_BUILD_ROWS]
    n = len(rows)
    res = {}
    route = cb._wgmma_route

    def no_int8(dtype, *args):
        return dtype != torch.int8 and route(dtype, *args)
    for name in ("kernel", "twin", "mma.sync"):
        idx = HnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                                   ef_search=64), device=dev,
                        search_expand_width=GRAPH_T)
        real = core_build.sweep_pool, core_build._connect_batch
        torch.cuda.synchronize()
        t0 = time.time()
        with own_twin_calls():
            if name == "twin":
                core_build.sweep_pool = loop_pool
                core_build._connect_batch = core_build._connect_batch_plain
            if name == "mma.sync":
                cb._wgmma_route = no_int8
            try:
                reset_launches()
                idx.build(rows)
                built = dict(cb.LAUNCHES)
            finally:
                core_build.sweep_pool, core_build._connect_batch = real
                cb._wgmma_route = route
            torch.cuda.synchronize()
            secs = time.time() - t0
            _, el, _ = idx.exact_search(qs, K)
            recalls = {}
            for t in (4, GRAPH_T):
                idx.search_expand_width = t
                _, gl, gv = idx.search(qs, K, mode="graph")
                recalls[t] = recall(gl, gv, el)
        sweeps = {k: v for k, v in built.items() if v}
        res[name] = (idx.graph.links[:n].cpu(), recalls, secs, sweeps)
        batches = len(core_build.build_schedule(n, idx.max_insert_batch))
        del idx
        torch.cuda.empty_cache()
    check(res["kernel"][3] == {"bruteforce_topk_q8_wgmma": batches - 1}
          and res["mma.sync"][3] == {"bruteforce_topk_q8": batches - 1},
          f"the 200k builds' sweeps: {res['kernel'][3]} by the rule, "
          f"{res['mma.sync'][3]} forced to mma.sync")
    for other, what in (("twin", "the torch-op loop and the plain wiring"),
                        ("mma.sync", "the mma.sync int8 sweep")):
        same = float((res["kernel"][0] == res[other][0]).all(1)
                     .float().mean())
        ts = (4, GRAPH_T) if other == "mma.sync" else (GRAPH_T,)
        log(f"{n}-row build through the sweep and wiring kernels "
            f"({res['kernel'][2]:.1f} s, sweeps {res['kernel'][3]}) and "
            f"with {what} in their place ({res[other][2]:.1f} s, sweeps "
            f"{res[other][3]}): link rows identical {same:.5f}; graph "
            f"recall@10 "
            + ", ".join(f"T={t} {res['kernel'][1][t]:.4f} / "
                        f"{res[other][1][t]:.4f}" for t in ts))
        check(same >= 0.999, f"kernel and {other} builds: {same} of link "
              f"rows")
        for t in ts:
            rk, rt = res["kernel"][1][t], res[other][1][t]
            check(abs(rk - rt) <= 0.002,
                  f"graph recall at T={t} {rk} vs the {other} build's {rt}")


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(work, timeout):
    """Start MP_WORLD ranks of this script on the card (``--rank``), wait
    for all; a rank that fails or outlasts ``timeout`` fails the phase, and
    every rank still running is killed.  Returns each rank's output."""
    port = free_port()
    logs = [os.path.join(work, f"rank{r}.log") for r in range(MP_WORLD)]
    procs = []
    try:
        for r in range(MP_WORLD):
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     str(r), "--world", str(MP_WORLD), "--port", str(port),
                     "--workdir", work], stdout=out,
                    stderr=subprocess.STDOUT))
        t0 = time.time()
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            check(not failed and time.time() - t0 < timeout,
                  f"ranks {failed} failed" if failed else
                  f"the ranks outlasted {timeout} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for path in logs:
            with open(path) as f:
                texts.append(f.read())
        for r, text in enumerate(texts):
            for line in text.splitlines()[-60:]:
                log(f"  [rank {r}] {line}")
    check(all(p.returncode == 0 for p in procs),
          f"rank exit codes {[p.returncode for p in procs]}")
    return texts


def explain(got, want, qs, pts, what):
    """Slots where two label arrays [B, k] differ; each must be explained
    as a float64 near-tie (the two rows within 1e-5 relative of each other
    from the query).  Prints the count; returns it."""
    rows, cols = np.nonzero(got != want)
    if len(rows):
        q = qs[rows].astype(np.float64)
        a = np.linalg.norm(pts[got[rows, cols].astype(np.int64)] - q, axis=1)
        b = np.linalg.norm(pts[want[rows, cols].astype(np.int64)] - q,
                           axis=1)
        tie = np.abs(a - b) <= 1e-5 * b + 1e-6
        log(f"{what}: {len(rows)} of {got.size} slots differ, "
            f"{int(tie.sum())} of them float64 near-ties (largest gap "
            f"{float(np.max(np.abs(a - b) / b)):.2e} relative)")
        check(bool(tie.all()),
              f"{what}: {int((~tie).sum())} differing slots are not "
              f"near-ties")
    return len(rows)


def multiprocess_phase(torch, HnswConfig, ShardedHnswIndex, dev, pts, qs,
                       tmp):
    """Phase 11: MP_WORLD gloo ranks on the one card, each holding 2 of the
    4 shards (rank_main).  (a) phase 9's per-shard snapshot of the 1M index,
    loaded by both; (b) deletes, per-shard save from the owners, load;
    (c) a build of the first MP_BUILD_ROWS rows across the ranks against a
    single-process S=4 build of the same rows here.  Returns the ranks'
    summed launch counts (each counted from zero in its rank)."""
    p9 = np.load(os.path.join(tmp, "phase9.npz"))
    alive = np.setdiff1d(np.arange(len(pts), dtype=np.uint64), p9["dead"])
    gone = np.random.default_rng(SEED + 6).choice(alive, 1_000,
                                                  replace=False)
    np.save(os.path.join(tmp, "mp_gone.npy"), gone)
    rows = pts[:MP_BUILD_ROWS]
    np.save(os.path.join(tmp, "mp_rows.npy"), rows)
    t0 = time.time()
    run_ranks(tmp, MP_TIMEOUT)
    ranks_s = time.time() - t0
    res = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
           for r in range(MP_WORLD)]
    for key in ("exact", "graph", "exact_del", "graph_del", "build_exact",
                "build_graph"):
        check(np.array_equal(res[0][key], res[1][key]),
              f"the ranks' {key} labels differ")
    got = res[0]
    swaps = explain(got["exact"], p9["exact"], qs, pts,
                    "two-rank exact labels vs phase 9's")
    gswaps = explain(got["graph"], p9["graph"], qs, pts,
                     "two-rank graph labels vs phase 9's")
    check(not np.isin(got["exact_del"], gone).any()
          and not np.isin(got["graph_del"], gone).any(),
          "a deleted label surfaced")

    single = ShardedHnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                                         ef_search=64), SHARDS, device=dev,
                              max_insert_batch=SHARD_BATCH,
                              search_expand_width=GRAPH_T)
    t0 = time.time()
    single.build(rows)
    torch.cuda.synchronize()
    single_s = time.time() - t0
    links = np.concatenate([r["links"] for r in res])
    counts = single.shard_counts
    same = [(links[i, :n] == single._links[i, :n].cpu().numpy()).all(axis=1)
            for i, n in enumerate(counts)]
    frac = float(np.concatenate(same).mean())
    check(frac >= 0.999, f"two-rank build: {frac} of link rows identical")
    _, sl_g, _ = single.search(qs, K, mode="graph")
    _, sl_e, _ = single.search(qs, K, mode="exact")
    bswaps = (explain(got["build_exact"], sl_e, qs, rows,
                      "two-rank 200k build exact labels vs one process's")
              + explain(got["build_graph"], sl_g, qs, rows,
                        "two-rank 200k build graph labels vs one "
                        "process's"))
    launches = {name: int(sum(r["launches"][i] for r in res))
                for i, name in enumerate(LAUNCH_NAMES)}
    log(f"two ranks on the card ({MP_WORLD} x {SHARDS // MP_WORLD} shards, "
        f"gloo): ran in {ranks_s:.1f} s; (a) phase 9's snapshot loaded in "
        f"{[round(float(r['load_s']), 1) for r in res]} s, exact labels "
        f"equal phase 9's except {swaps} float64 near-ties, graph labels "
        f"(T={GRAPH_T}, ef=64) except {gswaps}; exact "
        f"{[round(float(r['exact_qps'])) for r in res]} QPS and graph "
        f"{[round(float(r['graph_qps'])) for r in res]} QPS per rank, "
        f"{int(got['per_call'])} kernel launches a rank per exact call; "
        f"(b) 1,000 deletes never surface, per-shard save "
        f"{[round(float(r['save_s']), 1) for r in res]} s from the owners "
        f"loads back with the same labels; (c) {MP_BUILD_ROWS} rows built "
        f"in {[round(float(r['build_s']), 1) for r in res]} s per rank "
        f"against {single_s:.1f} s in one process, link rows identical "
        f"{frac:.5f}, labels equal on both routes except {bswaps} near-ties;"
        f" launches of the ranks {launches}")
    return launches


def rank_main(args):
    """One rank of phase 11 (``--rank R``): gloo over localhost, the
    card's cuda:0, 2 of the 4 shards.  Its checks run here; its answers go
    to rank<R>.npz in the work dir for the parent."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from pg_embedding_tpu_torch import HnswConfig, ShardedHnswIndex
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank,
                            timeout=timedelta(seconds=MP_TIMEOUT))
    group, w = dist.group.WORLD, args.workdir
    qs = np.load(os.path.join(w, "phase9.npz"))["qs"]
    out = {}
    reset_launches()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, time.time() - t0

    # (a) phase 9's snapshot, each rank reading its own shards' rows
    idx, out["load_s"] = timed(lambda: ShardedHnswIndex.load(
        os.path.join(w, "sharded.npz"), device=dev, group=group))
    idx.search_expand_width = GRAPH_T                  # not persisted
    check(idx.n_local == SHARDS // args.world
          and idx._vectors.shape[0] == idx.n_local, "the loaded shards")
    before = cb.LAUNCHES["bruteforce_topk_wgmma"]
    out["exact"] = idx.search(qs, K, mode="exact")[1]
    out["per_call"] = cb.LAUNCHES["bruteforce_topk_wgmma"] - before
    check(out["per_call"] == idx.n_local,
          f"one exact call launched the kernel {out['per_call']} times on "
          f"this rank, not {idx.n_local}")
    out["graph"] = idx.search(qs, K, mode="graph")[1]
    reps = 3
    _, t = timed(lambda: [idx.search(qs, K, mode="exact")
                          for _ in range(reps)])
    out["exact_qps"] = reps * len(qs) / t
    _, t = timed(lambda: [idx.search(qs, K, mode="graph")
                          for _ in range(reps)])
    out["graph_qps"] = reps * len(qs) / t

    # (b) deletes, then the owners' per-shard save, loaded back
    gone = np.load(os.path.join(w, "mp_gone.npy"))
    check(idx.delete(gone) == len(gone), "delete count")
    for mode in ("exact", "graph"):
        _, labels, valid = idx.search(qs, K, mode=mode)
        check(bool(valid.all()) and not np.isin(labels, gone).any(),
              f"{mode}: a deleted label surfaced")
        out[f"{mode}_del"] = labels
    path = os.path.join(w, "mp.npz")
    _, out["save_s"] = timed(lambda: idx.save(path, per_shard=True))
    back = ShardedHnswIndex.load(path, device=dev, group=group)
    back.search_expand_width = GRAPH_T
    for mode in ("exact", "graph"):
        check(np.array_equal(back.search(qs, K, mode=mode)[1],
                             out[f"{mode}_del"]),
              f"{mode}: the reloaded index answers differently")
    del idx, back
    torch.cuda.empty_cache()

    # (c) a build across the ranks
    rows = np.load(os.path.join(w, "mp_rows.npy"))
    built = ShardedHnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                                        ef_search=64), SHARDS, device=dev,
                             group=group, max_insert_batch=SHARD_BATCH,
                             search_expand_width=GRAPH_T)
    dist.barrier()
    _, out["build_s"] = timed(lambda: built.build(rows))
    out["links"] = built._links.cpu().numpy()
    out["build_exact"] = built.search(qs, K, mode="exact")[1]
    out["build_graph"] = built.search(qs, K, mode="graph")[1]
    counts = launch_counts()
    out["launches"] = np.array([counts[n] for n in LAUNCH_NAMES])
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.core import search as core_search
    check(core_search.PLAIN_WALKS_ON_CARD == 0,
          f"rank {args.rank} ran {core_search.PLAIN_WALKS_ON_CARD} plain "
          f"walks on the card")
    check(core_build.PLAIN_SWEEPS_ON_CARD == 0,
          f"rank {args.rank} ran {core_build.PLAIN_SWEEPS_ON_CARD} torch-op "
          f"sweeps on the card")
    check(core_build.PLAIN_CONNECTS_ON_CARD == 0,
          f"rank {args.rank} ran {core_build.PLAIN_CONNECTS_ON_CARD} plain "
          f"wirings on the card")
    np.savez(os.path.join(w, f"rank{args.rank}.npz"), **out)
    log(f"load {out['load_s']:.1f} s, exact {out['exact_qps']:.0f} QPS, "
        f"graph {out['graph_qps']:.0f} QPS, save {out['save_s']:.1f} s, "
        f"build of {len(rows)} rows {out['build_s']:.1f} s, launches "
        f"{counts}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


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
    build_s, sweeps = {}, {}
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
    for op in ops:
        name = ("bruteforce_topk_q8_l1" if op == "<~>"
                else "bruteforce_topk_q8_wgmma")
        before = (core_build.PLAIN_SWEEPS_ON_CARD, cb.LAUNCHES[name])
        t0 = time.time()
        t.create_index(op, m=16, ef_construction=64, ef_search=64)
        sync(torch.empty(0, device=dev))
        build_s[op] = time.time() - t0
        sweeps[op] = (core_build.PLAIN_SWEEPS_ON_CARD - before[0],
                      cb.LAUNCHES[name] - before[1])
    # every operator's index sweeps in the kernel, a launch a batch past
    # the first (Manhattan's own instance), and no torch-op loop
    batches = len(core_build.build_schedule(len(pts), 256))
    check(sweeps == dict.fromkeys(ops, (0, batches - 1)),
          f"the table's index builds swept {sweeps} (torch-op loops, "
          f"kernel launches), not one kernel launch a batch past the "
          f"first")
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
        f"opclass; pull scan equals order_by on 8; candidate sweeps of the "
        f"index builds (torch-op loops, bruteforce_topk_q8_wgmma / _q8_l1 "
        f"launches): {sweeps}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    # one rank of phase 11, started by the phase itself
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--workdir")
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pg_embedding_tpu_torch import (HnswConfig, HnswIndex,
                                        ShardedHnswIndex, VectorTable,
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
    # the phase-stamped build of the walk and the scan (phase 4b), beside
    # the port's own
    from pg_embedding_tpu_torch import graph_probe
    pool = concurrent.futures.ThreadPoolExecutor(1)
    profile_lib = pool.submit(graph_probe.build, "profile")
    _kernels.load_library()
    log(f"kernel build: {time.time() - t0:.1f} s (nvcc, sm_90a)")
    for var in _kernels.NVCC_ENV_FLAGS:
        if var in os.environ:
            log(f"kernel build: {var}={os.environ[var]!r} left out of "
                f"nvcc's environment")
    compiler_report(_kernels)

    timings = kernel_phase(torch, cb, dev)
    walk_variants = {}                 # variant_vs_twin's numbers, by name
    small_build_matches_cpu(torch, HnswConfig, HnswIndex, dev)
    path_launches = sweep_path_builds(torch, cb, HnswConfig, HnswIndex, dev)
    idx, pts, qs, main_launches, single = main_path(
        torch, cb, HnswConfig, HnswIndex, dev, args.n, args.queries)
    os.makedirs(os.path.join(REPO, ".kernel_build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(REPO, ".kernel_build")) as tmp:
        # the build's sweep instances: phase 3's errors, phase 4b's
        # numbers (Manhattan's exact route: the Manhattan phase's)
        phase3 = {name: timings.pop(name)["max_abs_err"]
                  for name in BUILD_SWEEPS + L1_SWEEPS}
        timings.update(walk_kernels_phase(torch, idx, qs, dev, tmp,
                                          single, profile_lib))
        twin_build_phase(torch, HnswConfig, HnswIndex, dev, pts, qs)
        paged_launches = wide_k_phase(torch, cb, idx, qs)
        serving_variants(torch, idx, qs, walk_variants)
        timings["beam_walk"]["wide_queues"] = wide_queue_phase(
            torch, idx, qs, timings["beam_walk"].pop("integer_wide_launches"))
        tuner_phase(idx, tmp)
        persistence(torch, HnswIndex, idx, qs, tmp)
        wal_recovery(torch, HnswIndex, idx, pts, qs, tmp)
        scan_check(idx, qs)
        pq_main(torch, idx, qs, walk_variants)
        shadows = (idx._pq_codebook, idx._pq_codes, idx._pcodes)
        bf16_launches, bf16_paged = bf16_phase(torch, cb, idx, qs,
                                               walk_variants)
        pq_after_downcast(idx, qs, shadows)
        del idx
        torch.cuda.empty_cache()
        l1_launches, l1_timings = manhattan_phase(
            torch, cb, HnswConfig, HnswIndex, dev, pts, qs, single["build_s"])
        timings.update(l1_timings)
        for name, err in phase3.items():
            timings[name]["max_abs_err"] = max(
                err, timings[name]["max_abs_err"])
        torch.cuda.empty_cache()
        sharded_launches = sharded_phase(torch, cb, HnswConfig,
                                         ShardedHnswIndex, dev, pts, qs,
                                         single, tmp)
        torch.cuda.empty_cache()
        mp_launches = multiprocess_phase(torch, HnswConfig,
                                         ShardedHnswIndex, dev, pts, qs, tmp)
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        del pts
        torch.cuda.empty_cache()
        pq_pool = pq_serving_phase(torch, HnswConfig, HnswIndex, dev,
                                   args.n, args.queries, tmp, walk_variants)
    # no candidate sweep of phases 4-11 ran the torch-op loop on the card
    from pg_embedding_tpu_torch.core import build as core_build
    check(core_build.PLAIN_SWEEPS_ON_CARD == 0,
          f"phases 4-11 ran {core_build.PLAIN_SWEEPS_ON_CARD} torch-op "
          f"candidate sweeps on the card")
    table_phase(torch, VectorTable, dev)
    # nor the table's, its Manhattan index included
    check(core_build.PLAIN_SWEEPS_ON_CARD == 0,
          f"the table ran {core_build.PLAIN_SWEEPS_ON_CARD} torch-op "
          f"candidate sweeps on the card")
    # no wiring of phases 4-11 and the table ran the plain twin on the card
    check(core_build.PLAIN_CONNECTS_ON_CARD == 0,
          f"the smoke's paths ran {core_build.PLAIN_CONNECTS_ON_CARD} plain "
          f"wirings on the card")

    # every walk variant reached the kernel through its own API path
    # (variant_vs_twin checks each path's count), and no walk of phases
    # 4-11 ran the plain twin on the card
    from pg_embedding_tpu_torch.core import search as core_search
    log(f"beam_walk launches by variant, each over its own API path (the "
        f"smoke's comparisons not counted): "
        f"{ {k: v['launches'] for k, v in walk_variants.items()} }")
    # (and the bf16 rows walk at API_T, bf16_phase; each visited set at
    # GRAPH_T and API_T)
    check(len(walk_variants) == len(WALK_SOURCES) + 2 * len(WALK_VISITED)
          + len(RECORDS_AT_API_T) + 1,
          f"variants held to their twin at 1M: {sorted(walk_variants)}")
    check(core_search.PLAIN_WALKS_ON_CARD == 0,
          f"phases 4-11 ran {core_search.PLAIN_WALKS_ON_CARD} plain walks "
          f"on the card")

    log(smi)
    kernels = []
    sweep = ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
             "pg_embedding_tpu/ops/pallas_bruteforce.py:58")
    for name, launches, (source, replaces) in (
            ("bruteforce_topk_wgmma", main_launches, sweep),
            ("bruteforce_topk_bf16_wgmma", bf16_launches, sweep),
            # the mma.sync instances: launches from the exact route's pages
            # past one launch (wide_k_phase, bf16_phase), which the rule
            # keeps on them; timed at the main path's shape, forced
            ("bruteforce_topk", paged_launches, sweep),
            ("bruteforce_topk_bf16", bf16_paged, sweep),
            ("bruteforce_topk_q8_wgmma", main_launches,
             ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
              "pg_embedding_tpu/core/build.py:287")),
            # the mma.sync int8 instance: launches from the exact8 build
            # whose pool the rule keeps on it (sweep_path_builds); timed at
            # phase 4b's batch, forced beside the Hopper one
            ("bruteforce_topk_q8", path_launches,
             ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
              "pg_embedding_tpu/core/build.py:287")),
            # exact mode's build sweep: launches from its own path, the
            # exact-mode builds (sweep_path_builds); its timings from phase
            # 4b's 1M batch (sweep_phase)
            ("bruteforce_topk_wide", path_launches,
             ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
              "pg_embedding_tpu/core/build.py:287")),
            ("bruteforce_topk_bf16_wide", path_launches,
             ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
              "pg_embedding_tpu/core/build.py:287")),
            # Manhattan's instances: launches from the Manhattan index's
            # path (manhattan_phase); the build's sweep timed at phase 4b's
            # batch, the exact route at 1M
            ("bruteforce_topk_l1", l1_launches,
             ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
              "pg_embedding_tpu/ops/bruteforce.py:87")),
            ("bruteforce_topk_bf16_l1", l1_launches,
             ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
              "pg_embedding_tpu/ops/bruteforce.py:87")),
            ("bruteforce_topk_q8_l1", l1_launches,
             ("pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
              "pg_embedding_tpu/core/build.py:287")),
            ("beam_walk", main_launches,
             ("pg_embedding_tpu_torch/csrc/beam_walk.cu",
              "pg_embedding_tpu/core/search.py:80")),
            ("prune_scan", main_launches,
             ("pg_embedding_tpu_torch/csrc/prune_scan.cu",
              "pg_embedding_tpu/core/build.py:44")),
            ("connect_batch", main_launches,
             ("pg_embedding_tpu_torch/csrc/connect_batch.cu",
              "pg_embedding_tpu/core/build.py:172")),
            # the compressed sweep's pool: launches from its own path,
            # phase 8's sweep_pq (pq_sweep_phase), as its timings
            ("bruteforce_topk_pq", {"bruteforce_topk_pq":
                                    pq_pool.pop("launches")},
             ("pg_embedding_tpu_torch/csrc/pq_topk.cu",
              "pg_embedding_tpu/ops/pq_sweep.py:36"))):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "sharded_launches": sharded_launches[name],
            "multiprocess_launches": mp_launches[name],
            **(pq_pool if name == "bruteforce_topk_pq" else timings[name])})
        if name == "beam_walk":
            kernels[-1]["variants"] = walk_variants
    for name in L1_SWEEPS:
        check(l1_launches[name] > 0,
              f"the Manhattan path never launched {name}")
    for name in ("bruteforce_topk_wgmma", "bruteforce_topk_q8_wgmma",
                 "beam_walk",
                 "prune_scan", "connect_batch"):
        check(main_launches[name] > 0,
              f"the main path never launched {name}")
        check(sharded_launches[name] > 0,
              f"the sharded path never launched {name}")
        check(mp_launches[name] > 0, f"the two ranks never launched {name}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
