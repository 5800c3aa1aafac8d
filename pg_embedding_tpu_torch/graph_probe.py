"""Where the walk, prune and wiring kernels' time goes, on one NVIDIA GPU.

  python -m pg_embedding_tpu_torch.graph_probe [--n ROWS] [--reps N]
  python -m pg_embedding_tpu_torch.graph_probe --mode wiring [--n ROWS]
  python -m pg_embedding_tpu_torch.graph_probe --mode wide [--n ROWS]
      [--before FILE]
  python -m pg_embedding_tpu_torch.graph_probe --mode pq [--n ROWS]
      [--before FILE]
  python -m pg_embedding_tpu_torch.graph_probe --mode records [--n ROWS]
      [--before FILE]
  python -m pg_embedding_tpu_torch.graph_probe --mode rows [--n ROWS]
      [--before FILE]
  python -m pg_embedding_tpu_torch.graph_probe --mode sets [--n ROWS]
      [--before FILE]

Builds csrc/beam_walk.cu and csrc/prune_scan.cu in variants, each a rewrite
of the sources' text (as sweep_probe.py builds its variants) compiled into
its own library under .kernel_build/graph_probe/, all side by side:
  kernel        the sources as they are
  profile       the same with clock64() stamps (-DPG_PROFILE): thread 0 of
                each walk block, lane 0 of each scan warp, sums the cycles
                of each phase; the main path never launches it
  dense         the walk's dedupe by comparison with the queues and the
                earlier slots (its fallback where the hash tables do not
                fit, and the design before them)
  rank1 / rank32   the admitted ranked a thread an entry (the design
                before) or a warp an entry, instead of as many lanes an
                entry as the block can spare
  rows4 / rows16   4 or 16 neighbour rows a warp at a time instead of 8
  threads128 / threads256   one block shape for every T
  blocks8       8 blocks of 128 threads an SM (64 registers) instead of 5
  blocks3       3 blocks of 256 threads an SM (80 registers) instead of 4
  sets-runtime  the dense dedupe's instances keep the visited sets' runtime
                branches (one instance for every visited set)
  widen-at-load each neighbour row widened to float32 right behind its
                load (int8 x its scale, bf16, PQ), not after all of a
                warp's rows are loaded
  wide-from-256 / tables-to-4096   the wide instances (the held set kept
                from step to step, the merge in place) from queues past
                256, or past 4096, instead of past 320
  move-run-2 / move-run-8   the wide instances' merge moving 2 or 8
                incumbents a thread a round instead of 4
  one-block     the wide instances at one block an SM (255 registers; the
                launch asks ONE_BLOCK_PAD more bytes of shared memory than
                it uses) instead of two
  records-cp-async   int8 / bf16 records staged by 16-byte cp.async.cg
                copies spread over the block's threads instead of the copy
                engine's bulk copy a record (_CP_ASYNC_STAGE)
  records-prefetch   the table instances' phase 1 asks L2 for each popped
                row's int8 / bf16 record (cp.async.bulk.prefetch.L2), for
                the walks launched unstaged (_PREFETCH)
  ring-prefetch the float32 records ring with an L2 prefetch of the rows
                past K in phase 2 (cp.async.bulk.prefetch.L2), which phase
                3 reads from the records (_RING_PREFETCH)
  ring-wait-first    the float32 records ring's phase 3 waits for the
                ring before it scores the rows past K (no overlap of the
                two)
  ring-threads128    the float32 records ring's instances at 128 threads
                for every T (96 registers; at T maxM > 128 a thread takes
                two slots)
  ring-blocks3  the float32 records ring's 256-thread instances at 3 blocks
                an SM (80 registers) instead of 4
  rows-prefetch the float32 records walk with no ring: phase 2 asks L2
                for each processed slot's record row as the dedupe keeps
                it (every block and all of L1 kept), for the walks
                launched unstaged (_ROWS_PREFETCH)
  rows-phase-1  staged int8 / bf16 rows copied for every valid slot as its
                link lands in phase 1 (the table instances), instead of
                for the processed slots as phase 2's dedupe keeps them;
                rows-phase-1-profile is its profile build
  rows-warp / rows-phase-1-warp   either schedule with one arrival a
                warp's slots on the barrier (their summed bytes) instead
                of one a slot
  rows-no-fence the staged rows' copies without the proxy fence before
                each (a diagnostic: it measures the fence)
  sets-phase-2  the bitmap and hash sets' words read in phase 2, after the
                links' barrier, as the tree before read them (the table
                and wide instances); sets-phase-2-profile is its profile
                build
  sets-warp-0   the hash set's ordered writes by warp 0, each chunk read
                after the one before has written, as the tree before wrote
                them, instead of by the last warp reading a chunk ahead;
                sets-warp-0-profile is its profile build
  sets-dyn-end  a shared set found at the end of the block's dynamic
                shared memory (%dynamic_smem_size) instead of by the
                layout's offset
  sets-padded   the C side takes a device set beside shared bytes that
                count the set (walk's visited_shared="padded": the block
                padded to the shared set's bytes, the set in device
                memory; a diagnostic: it measures what the bytes cost)

The probe builds an index of ``--n`` rows x 128-d on the card
(utils/io.synthetic_clustered, chip_smoke.py's recipe and seed), walks its
1,024 queries at ef = 64, T = 4 and 8 (float32 rows; and int8 rows, the
quantized traversal, for the kernel and widen-at-load), and captures the
candidate sets of one 256-row add()'s insert prune (B = 256, C = 128, nn =
16; its back-link re-prunes run inside csrc/connect_batch.cu, not the
scan).  Every walk variant's answers are checked against the kernel's
(ids, hops and evals); the scan is timed and its profile build's phases
printed.  Times are the card's (device_ms: ``--reps`` calls in a
CUDA graph, replayed between CUDA events), so a small kernel is not timed
by the host's launch overhead; variants are timed in turns, then in
reverse order, and the card's name and power limit are printed first.
chip_smoke.py prints the profile build's breakdown at the same shapes
(``walk_phases``, ``prune_phases``).

``--mode wide`` times the walk's wide instances on the same 1M index at
T = 8, (ef, cand_cap) in WIDE_SHAPES, on the first 64 and all 1,024
queries: kernel, one-block, move-run-2 and move-run-8 (at (5120, 5120))
and, with ``--before FILE`` (an earlier tree's csrc/beam_walk.cu,
launched with that tree's layout and arguments: its wide queues and held
table in device memory, rebuilt each step), "before", in turns, each
checked against the kernel (ids, distances, hops, evals), then the
profile build's laps a block-step (merge: the admitted's places; move:
the displaced incumbents, and the held bits of those pushed out; held
set: the admitted's held bits); then the crossover: ef = cand_cap in
CROSSOVER through the kernel and through the other scheme (wide-from-256
up to 320, tables-to-4096 past it).  Times are device_ms (``--reps``
calls, 3 by default in this mode).

``--mode pq`` times the PQ walk (the table instances' PQ row source: the
query's distance table in shared memory) on the same 1M index at T = 8,
ef = 64, PQ trained by the index (HnswIndex._ensure_pq_codebook) at
PQ_CASES: G = 16, 32 and 64 under L2, OPQ at G = 32 and cosine at G = 32;
with ``--before FILE`` (an earlier tree's csrc/beam_walk.cu, its row
source the codebook read through the read-only cache, launched without
the table's bytes) against it, in turns (kernel, before, before, kernel),
beside the float32 rows' walks at T = 4 and 8 (the main path's instances,
which the table leaves as they were).  Each case's answers are checked:
against the earlier tree's bit for bit (ids, distances, hops, evals) at G
= 32, and against the plain twin (core/search._search_batch on the card)
by chip_smoke.py's bar at every G (recall@10 after finish_walk against the
exact route under the walk's metric within 0.002, ids on >= 98% of
queries, mean hops and dist_evals within 1%).  Then the profile builds'
laps a block-step, the kernel's and the earlier tree's (setup: the
table's build, once a block), and the PQ instances' ptxas reports.

``--mode records`` times the int8, bf16 and float32 records walks (the
API's packed_dtype "int8", "bfloat16" and "float32") on the same 1M index
at ef = 64, T = 4 and 8, each placement the launch can ask for
(RECORDS_RUNS; float32's FLOAT32_RUNS): int8 / bf16 staged by the bulk
copy (the kernel's), staged by cp.async (records-cp-async), read from the
records (the kernel's unstaged instance), read from the records after an
L2 prefetch (records-prefetch); float32 through the ring at its largest K
(the kernel's), at K = 64 and 32, with an L2 prefetch of the rows past K
(ring-prefetch), waited for before the rows past K are scored
(ring-wait-first), with no ring but each processed row asked of L2
(rows-prefetch), read from the records (and at T = 2 the ring, unstaged
and before alone); and, with ``--before FILE`` (an
earlier tree's csrc/beam_walk.cu, laid out with no staging), "before",
in turns (in order, then reversed; ``--turns N`` rounds of that), each
checked against the placement ops/cuda_graph._records_place chooses bit
for bit (ids, distances, hops, evals) and that one against the plain
twin by chip_smoke.py's bar (float32: ids, hops and evals equal on every
query); beside them the float32 rows' walks at T = 4 and 8 (the main
path's instances) against "before", with the profile builds' laps.
Each case prints its shared memory a block, staged and unstaged, and the
blocks an SM of each (walk_blocks: the runtime's occupancy), then the
profile builds' laps a block-step (the kernel's, at the chosen
placement; the earlier tree's), and the records instances' ptxas
reports; exits 1 if a check fails.

``--mode rows`` does the same for the int8 rows (the quantized traversal:
HnswIndex._ensure_quantized's rows x scales) and the bf16 corpus rows (the
index's rows cast to bf16, as downcast_corpus stores them), at T = 4 and
8, in each placement of ROWS_RUNS: staged by a bulk copy a processed slot
in phase 2 (the kernel's), by one a valid slot as its link lands in phase
1 (rows-phase-1), either with one arrival a warp (rows-warp,
rows-phase-1-warp), without the proxy fence (rows-no-fence), read from
the rows (the kernel's unstaged instance) and, with ``--before FILE``,
the earlier tree's walk (which read the rows), each checked against the
placement _records_place chooses bit for bit and that one against the
plain twin; then the laps of the profile builds (the kernel's at its
placement, rows-phase-1's, the earlier tree's).

``--mode sets`` times the bitmap and hash visited sets' walks over float32
rows (``visited_slots`` 0 and 2^s) on the same 1M index: the hash set at
8,192 slots (the API's at ef 64) at T = 4 and 8 and at 16,384 (ef 128) at
T = 8, the bitmap at T = 4 and 8, and both sets in the wide instances at
ef = cand_cap = 5,120 on 64 queries; then the bitmap at T = 4 and 8 on a
second index of SETS_SMALL_N rows (100,000: its bitmap fits a block).
Each in turns (in order, then reversed; ``--turns N`` rounds of that,
1 by default): the kernel at the placement
ops/cuda_graph._visited_place chooses, sets-phase-2 (the words read in
phase 2), sets-warp-0 (the hash set's writes as before), the other
placement where a table instance can take it (the
set forced to device memory, or into shared memory whatever an SM then
holds), there sets-padded's device set in a block padded to the shared
set's bytes, sets-dyn-end at the kernel's placement (the table cases)
and, with ``--before FILE`` (an earlier tree's csrc/beam_walk.cu,
its sets in device memory), "before"; each checked against the kernel
bit for bit (ids, distances, hops, evals), the kernel against the plain
twin on the card at T = 8 on 1,024 queries (ids, hops and evals per
query); beside them the wrapper's fill of a device set alone and the
dense float32 rows' walks at T = 4 and 8 against "before"; then the
laps of the profile builds (the kernel's, sets-phase-2's, sets-warp-0's,
the earlier tree's), after the float32 instances' ptxas reports; exits 1
if a check fails.

``--mode wiring`` builds csrc/connect_batch.cu in its own variants
(WIRING_VARIANTS):
  kernel        the source as it is: a warp per sorted op
  profile       the source with clock64() laps (-DPG_PROFILE): lane 0 of
                each warp that heads a chain sums the cycles of each phase
                (head: the ops, the count and an appends-only chain's
                store; row; a re-prune's stage, d, ranks, masks and scan;
                the row's write) and the longest chain's total
  profile-near-rows   the profile build staging rows 0 .. 63 of the table
                (id mod 64: 32 KB, one page) in place of the candidates'
                scattered rows; its stage lap against the profile's says
                what the rows' spread over the table costs (its rows and
                counts differ)
  no-masks      the masks left empty (every valid candidate kept, up to
                maxM): its time against the kernel's is what the masks
                cost the launch (rows differ)
  no-copy       the re-prunes' rows not copied (the warp computes on what
                its slice holds): what the copies cost (rows differ)
builds the same index, captures one add()'s wiring (core/build's
_connect_batch operands) and times both variants on the card (device_ms,
in turns, then reversed) on that batch and on an appends-only one (the
same ops, every non-member target's count at 0: no re-prune) and on a
re-prunes-only one (only the chains that re-prune), each variant's rows
checked against the kernel's; then the profile build's
laps on both batches.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import re
import subprocess

import numpy as np
import torch

from . import _kernels
from .ops import cuda_graph as cg
from .ops.distance import dist_one_to_many

OUT = os.path.join(_kernels.BUILD_DIR, "graph_probe")
CSRC = os.path.join(_kernels._PKG_DIR, "csrc")
WALK, SCAN, WIRE = "beam_walk.cu", "prune_scan.cu", "connect_batch.cu"
SOURCES = (WALK, SCAN)
WIRING_SOURCES = (WIRE,)
WALK_PHASES = ("setup + output", "links + inserts", "dedupe", "rows",
               "rank", "merge", "move", "held set")
PRUNE_PHASES = ("init", "search", "reject", "write")
WIRING_PHASES = ("head", "row", "stage", "d", "ranks", "masks", "scan",
                 "write")
PROFILE = ("-DPG_PROFILE",)
_RANK = ("  int g = 1;\n"
         "  while (g < 32 && 2 * g * n_new <= kThreads) g *= 2;\n")
_WIDEN_AT_LOAD = (
    "#pragma unroll\n"
    "        for (int u = 0; u < R; ++u) {\n"
    "          if (at[u] < 0) continue;\n"
    "          raw[u] = load4<kElem>(src, rs, at[u], c, D);\n"
    "          if (kType == kElemI8) sc[u] = scale_at<kElem>(src, rs, at[u]);"
    "\n"
    "        }\n"
    "#pragma unroll\n"
    "        for (int u = 0; u < R; ++u) {\n"
    "          if (at[u] < 0) continue;\n"
    "          const float4 pv =\n"
    "              widen4<kType>(raw[u], kType == kElemI8 ? sc[u] : 1.f);\n",
    "        float4 pvs[R];\n"
    "#pragma unroll\n"
    "        for (int u = 0; u < R; ++u) {\n"
    "          if (at[u] < 0) continue;\n"
    "          if (kType == kElemI8) sc[u] = scale_at<kElem>(src, rs, at[u]);"
    "\n"
    "          pvs[u] = widen4<kType>(load4<kElem>(src, rs, at[u], c, D),\n"
    "                                 kType == kElemI8 ? sc[u] : 1.f);\n"
    "        }\n"
    "#pragma unroll\n"
    "        for (int u = 0; u < R; ++u) {\n"
    "          if (at[u] < 0) continue;\n"
    "          const float4 pv = pvs[u];\n")
# stage_records's bulk copies, and the same copies as 16-byte cp.async.cg
# chunks spread over the block's threads (then cp.async.wait_all in place
# of the barrier's wait)
_BULK_STAGE = (
    "  for (int j = tid; j < T; j += kThreads) {\n"
    "    const int p = pop_i[j];\n"
    "    const bool go = p >= 0 && !(pop_d[j] > lower);\n")
_CP_ASYNC_STAGE = (
    "  const int chunks = (int)((record + scales) / 16);\n"
    "  for (int i = tid; i < T * chunks; i += kThreads) {\n"
    "    const int j = i / chunks, k = i - j * chunks;\n"
    "    const int p = pop_i[j];\n"
    "    if (p < 0 || pop_d[j] > lower) continue;\n"
    "    const unsigned char* from =\n"
    "        k * 16u < record\n"
    "            ? rec + (size_t)p * record + k * 16\n"
    "            : reinterpret_cast<const unsigned char*>(src.scales) +\n"
    "                  (size_t)p * scales + (k * 16 - record);\n"
    "    unsigned char* to =\n"
    "        k * 16u < record\n"
    "            ? rs.rows + (size_t)j * record + k * 16\n"
    "            : reinterpret_cast<unsigned char*>(rs.scales) +\n"
    "                  (size_t)j * scales + (k * 16 - record);\n"
    "    asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\" ::\n"
    "                 \"r\"(smem_addr(to)), \"l\"(from) : \"memory\");\n"
    "  }\n"
    "  if (false)\n" + _BULK_STAGE)
# the float32 records ring's phase 2 asking L2 for each processed slot's
# row past K
_RING_TAIL = ("  if (!copy) return;\n"
              "  const int j = s / maxM;\n"
              "  const unsigned char* from =\n"
              "      static_cast<const unsigned char*>(src.rows) +\n"
              "      ((size_t)pop_i[j] * maxM + (s - j * maxM)) * row;\n")
_RING_PREFETCH = (
    "  if (e < 0) return;\n"
    "  const int j = s / maxM;\n"
    "  const unsigned char* from =\n"
    "      static_cast<const unsigned char*>(src.rows) +\n"
    "      ((size_t)pop_i[j] * maxM + (s - j * maxM)) * row;\n"
    "  if (!copy) {\n"
    "    asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" ::\n"
    "                 \"l\"(from), \"r\"(row) : \"memory\");\n"
    "    return;\n"
    "  }\n")
# float32 records with no ring: phase 2's dedupe asks L2 for each processed
# slot's record row as it keeps it (where the ring's copies would go)
_RING_CALL = ("      // float32 records in a ring: each processed slot's row "
              "copied to its\n")
_ROWS_PREFETCH = (
    "      if constexpr (kElem == kElemF32)\n"
    "        if (src.records && keep && D % 4 == 0) {\n"
    "          const int j = s / maxM;\n"
    "          asm volatile(\n"
    "              \"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" ::\n"
    "              \"l\"(static_cast<const float*>(src.rows) +\n"
    "                  ((size_t)ci[j] * maxM + (s - j * maxM)) * D),\n"
    "              \"r\"((unsigned)D * 4) : \"memory\");\n"
    "        }\n" + _RING_CALL)
# the table instances' phase 1, after the stage: an L2 prefetch of each
# popped row's int8 / bf16 record (and an int8 record's scales) where the
# walk reads the records
_STAGE_CALL = ("      stage_records<kElem, kThreads>(src, ci, cd, lower, T, "
               "maxM, D, rs, tid);\n")
_PREFETCH = _STAGE_CALL + (
    "    if constexpr (kElem == kElemI8 || kElem == kElemBF16) {\n"
    "      const unsigned record = (unsigned)maxM * D * "
    "(kElem == kElemI8 ? 1 : 2);\n"
    "      const unsigned char* rec =\n"
    "          static_cast<const unsigned char*>(src.rows);\n"
    "      const bool ok = src.records && record % 16 == 0 &&\n"
    "                      reinterpret_cast<uintptr_t>(rec) % 16 == 0;\n"
    "      const bool sc =\n"
    "          kElem == kElemI8 && maxM % 4 == 0 &&\n"
    "          reinterpret_cast<uintptr_t>(src.scales) % 16 == 0;\n"
    "      for (int j = tid; ok && j < T; j += kThreads) {\n"
    "        const int p = ci[j];\n"
    "        if (p < 0 || cd[j] > lower) continue;\n"
    "        asm volatile(\n"
    "            \"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" ::\n"
    "            \"l\"(rec + (size_t)p * record), \"r\"(record)\n"
    "            : \"memory\");\n"
    "        if (sc)\n"
    "          asm volatile(\n"
    "              \"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" ::\n"
    "              \"l\"(src.scales + (size_t)p * maxM),\n"
    "              \"r\"((unsigned)maxM * 4) : \"memory\");\n"
    "      }\n"
    "    }\n")
# the staged rows' copies: the kernel's, a processed slot's as phase 2's
# dedupe keeps it (after each kernel's ballot), or a valid slot's as its
# link lands in phase 1 (the table instances' loop)
_TABLE_BALLOT = (
    "                                  vis_mode, id);\n"
    "      }\n"
    "      const unsigned m = __ballot_sync(kFull, keep);\n")
_WIDE_BALLOT = (
    "            id);\n"
    "      }\n"
    "      const unsigned m = __ballot_sync(kFull, keep);\n")
_PROCESSED_CALL = (
    "      // a staged rows source: each processed slot's row copied as the\n"
    "      // dedupe keeps it (stage_row)\n"
    "      if constexpr (is_staged(kElem))\n"
    "        if (!src.records && s < tm)\n"
    "          stage_row<kElem>(src, rs, s, keep ? id : -1, D);\n")
_LINK_ID = "      const int id = left > 0 && link >= 0 ? link : -1;\n"
_PHASE1_CALL = (
    "      if constexpr (is_staged(kElem))\n"
    "        if (!src.records) stage_row<kElem>(src, rs, s, id, D);\n")
# the staged rows' arrivals one a warp's slots, the first lane of ``mask``
# (the warp's lanes at the call) carrying their summed bytes, instead of
# one a slot: (T maxM + 31) / 32 a phase, a warp's 32 slots at once
_STAGE_WARP = (
    "template <int kElem>\n"
    "__device__ __forceinline__ void stage_rows_warp(const RowSource& src,\n"
    "    const RecStage& rs, int s, int id, int D, unsigned mask) {\n"
    "  constexpr bool kI8 = elem_type(kElem) == kElemI8;\n"
    "  const unsigned row = (unsigned)D * (kI8 ? 1 : 2);\n"
    "  const unsigned n = __popc(__ballot_sync(mask, id >= 0));\n"
    "  if ((threadIdx.x & 31) == __ffs(mask) - 1)\n"
    "    mbar_arrive_expect(rs.bar, n * row);\n"
    "  __syncwarp(mask);\n"
    "  if (id >= 0) {\n"
    "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
    "    bulk_copy(rs.rows + (size_t)s * row,\n"
    "              static_cast<const unsigned char*>(src.rows) +\n"
    "                  (size_t)id * row, row, rs.bar);\n"
    "    if (kI8) cp_async(rs.scales + s, src.scales + id, 4);\n"
    "  }\n"
    "}\n\n")
_WARP_CALL = (
    "      if constexpr (is_staged(kElem))\n"
    "        if (!src.records)\n"
    "          stage_rows_warp<kElem>(src, rs, s, keep ? id : -1, D, "
    "kFull);\n")
# phase 1's loop: a warp's lanes at one slot s are a prefix of the warp
_PHASE1_WARP_CALL = (
    "      if constexpr (is_staged(kElem))\n"
    "        if (!src.records)\n"
    "          stage_rows_warp<kElem>(src, rs, s, id, D,\n"
    "              tm - (s - (tid & 31)) >= 32\n"
    "                  ? kFull : (1u << (tm - (s - (tid & 31)))) - 1u);\n")
_WARP_COMMON = (
    (WALK, "// The arrivals a phase of a staged source's barrier",
     _STAGE_WARP + "// The arrivals a phase of a staged source's barrier"),
    (WALK, "  return src.records ? T : tm;\n",
     "  return src.records ? T : (tm + 31) / 32;\n"),
    (WALK, _WIDE_BALLOT + _PROCESSED_CALL, _WIDE_BALLOT + _WARP_CALL))
_ROWS_PHASE1 = (
    (WALK, _TABLE_BALLOT + _PROCESSED_CALL, _TABLE_BALLOT),
    (WALK, _LINK_ID, _LINK_ID + _PHASE1_CALL))
_ROWS_WARP = _WARP_COMMON + (
    (WALK, _TABLE_BALLOT + _PROCESSED_CALL, _TABLE_BALLOT + _WARP_CALL),)
_ROWS_PHASE1_WARP = _WARP_COMMON + (
    (WALK, _TABLE_BALLOT + _PROCESSED_CALL, _TABLE_BALLOT),
    (WALK, _LINK_ID, _LINK_ID + _PHASE1_WARP_CALL))
# the visited sets' words read in phase 2, after the barrier (the tree
# before: each slot's read a dependent latency of its own), in the table
# instances and the wide ones
_SETS_PHASE_2 = (
    (WALK, "      if constexpr (!kDense)\n"
     "        if (s == tid && id >= 0) pre = vis_word(vis, vis_mode, vis_n, "
     "id);\n", ""),
    (WALK, "        keep = keep && !vis_holds(s == tid ? pre\n"
     "                                           : vis_word(vis, vis_mode, "
     "vis_n, id),\n"
     "                                  vis_mode, id);\n",
     "        keep = keep && !vis_holds(vis_word(vis, vis_mode, vis_n, id),\n"
     "                                  vis_mode, id);\n"),
    (WALK, "          pre = dense ? make_int4((int)__ldcg(held + (id >> 4)), "
     "0, 0, 0)\n"
     "                      : vis_word(vis, vis_mode, vis_n, id);\n",
     "          if (dense) pre = make_int4((int)__ldcg(held + (id >> 4)), 0, "
     "0, 0);\n"),
    (WALK, "        keep = !vis_holds(\n"
     "            s == tid ? pre : vis_word(vis, vis_mode, vis_n, id), "
     "vis_mode,\n"
     "            id);\n",
     "        keep = !vis_holds(vis_word(vis, vis_mode, vis_n, id), vis_mode,"
     "\n            id);\n"))
# the hash set's ordered writes by warp 0, each chunk's bits and ids read
# after the chunk before has written (the tree before), in place of the
# last warp's, read a chunk ahead
# sets-dyn-end: a shared set found at the end of the block's dynamic
# shared memory (%dynamic_smem_size) instead of by the layout's offset
_SETS_DYN_END = ((WALK, """      size_t at = region - smem;
      if constexpr (is_pq(kElem))
        at += pq_region_bytes<kElem>(src, metric, T, maxM);
      if constexpr (is_staged(kElem))
        at += rec_stage_bytes(elem_type(kElem) == kElemI8 ? 1 : 2,
                              elem_type(kElem) == kElemI8, T, maxM, D);
      if constexpr (is_ring(kElem)) at += (size_t)src.ring * D * 4;
      vis = reinterpret_cast<int*>(smem + round16(at));
""", """      unsigned dyn;
      asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
      vis = reinterpret_cast<int*>(smem + dyn - round16(4 * (size_t)vis_n));
"""),)
# sets-padded: the layout counts a table instance's set wherever it fits,
# and a launch may pass a device set beside those bytes (walk's
# visited_shared="padded": the set in device memory, the block padded to
# the shared one's bytes)
_SETS_PADDED = (
    (WALK, "vis_shared ? (size_t)vis_n : 0, ring);",
     "vis_mode != kVisDense ? (size_t)vis_n : 0, ring);"),
    (WALK, "      lay.vis.shared != (int)vis_shared)", "      !lay.vis.shared)"))
_SETS_WARP_0 = (
    (WALK, "  } else if (vis_mode == kVisHash && warp == kThreads / 32 - 1) "
     "{\n",
     "  } else if (vis_mode == kVisHash && warp == 0) {\n"
     "    for (int c = 0; c * 32 < tm; ++c) {\n"
     "      const int s = c * 32 + lane;\n"
     "      const bool mine = (proc_bits[c] >> lane) & 1u;\n"
     "      const int id = mine ? slot_id[s] : 0;\n"
     "      const int at = mine ? vis_slot(id, vis_n) : -1 - lane;\n"
     "      const unsigned peers = __match_any_sync(kFull, at);\n"
     "      if (mine && lane == 31 - __clz(peers)) vis[at] = id;\n"
     "      __syncwarp();\n"
     "    }\n"
     "  } else if (false) {\n"),)
# name: (nvcc flags, rewrites (source, text, replacement))
VARIANTS = {
    "kernel": ((), ()),
    "profile": (PROFILE, ()),
    "dense": ((), ((WALK, "  if (base + tables <= (size_t)kSmemLimit) {\n",
                    "  if (false) {\n"),)),
    "rank1": ((), ((WALK, _RANK, "  int g = 1;\n"),)),
    "rank32": ((), ((WALK, _RANK, "  int g = 32;\n"),)),
    "rows4": ((), ((WALK, "kRowsPerWarp = 8;", "kRowsPerWarp = 4;"),)),
    "rows16": ((), ((WALK, "kRowsPerWarp = 8;", "kRowsPerWarp = 16;"),)),
    "threads128": ((), ((WALK, "  return T * maxM <= 128 ? 128 : 256;\n",
                         "  return 128;\n"),)),
    "threads256": ((), ((WALK, "  return T * maxM <= 128 ? 128 : 256;\n",
                         "  return 256;\n"),)),
    "blocks8": ((), ((WALK, "kThreads == 128 ? 5 : 4;",
                      "kThreads == 128 ? 8 : 4;"),)),
    "blocks3": ((), ((WALK, "kThreads == 128 ? 5 : 4;",
                      "kThreads == 128 ? 5 : 3;"),)),
    "sets-runtime": ((), ((WALK, "  const int vis_mode = kDense ? kVisDense"
                           " : vis_set;\n",
                           "  const int vis_mode = vis_set;\n"),)),
    "widen-at-load": ((), ((WALK, *_WIDEN_AT_LOAD),)),
    "wide-from-256": ((), ((WALK, "constexpr int kMaxQueue = 320;",
                            "constexpr int kMaxQueue = 256;"),)),
    "tables-to-4096": ((), ((WALK, "constexpr int kMaxQueue = 320;",
                             "constexpr int kMaxQueue = 4096;"),)),
    "move-run-2": ((), ((WALK, "constexpr int kMoveRun = 4;",
                         "constexpr int kMoveRun = 2;"),)),
    "move-run-8": ((), ((WALK, "constexpr int kMoveRun = 4;",
                         "constexpr int kMoveRun = 8;"),)),
    "records-cp-async": ((), (
        (WALK, _BULK_STAGE, _CP_ASYNC_STAGE),
        (WALK, "  mbar_wait(rs.bar, (unsigned)step & 1u);\n",
         "  cp_async_wait_all();\n"))),
    "records-prefetch": ((), ((WALK, _STAGE_CALL, _PREFETCH),)),
    "ring-prefetch": ((), ((WALK, _RING_TAIL, _RING_PREFETCH),)),
    "ring-threads128": ((), (
        (WALK, "  const bool wide = walk_threads(a.T, a.maxM) > 128;\n",
         "  const bool wide = !is_ring(kElem) && walk_threads(a.T, a.maxM) > "
         "128;\n"),
        (WALK, "  const bool w = walk_threads(T, maxM) > 128;\n",
         "  const bool w = !is_ring(kElem) && walk_threads(T, maxM) > 128;\n"),
    )),
    "ring-blocks3": ((), ((
        WALK, "__launch_bounds__(kThreads, kMinBlocks<kThreads>)\n"
        "beam_walk_kernel(",
        "__launch_bounds__(kThreads, is_ring(kElem) && kThreads == 256 ? 3\n"
        "                                : kMinBlocks<kThreads>)\n"
        "beam_walk_kernel("),)),
    "ring-wait-first": ((), (
        (WALK, "  wait_records(rs, step);\n", ""),
        (WALK, "  const int k = min(src.ring, n_proc);\n",
         "  const int k = min(src.ring, n_proc);\n  wait_records(rs, step);\n"),
    )),
    "rows-prefetch": ((), ((WALK, _RING_CALL, _ROWS_PREFETCH),)),
    "rows-phase-1": ((), _ROWS_PHASE1),
    "rows-phase-1-profile": (PROFILE, _ROWS_PHASE1),
    "rows-warp": ((), _ROWS_WARP),
    "rows-phase-1-warp": ((), _ROWS_PHASE1_WARP),
    "rows-no-fence": ((), ((
        WALK, "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
        "\"memory\");\n    bulk_copy(rs.rows + (size_t)s * row,",
        "    bulk_copy(rs.rows + (size_t)s * row,"),)),
    "sets-phase-2": ((), _SETS_PHASE_2),
    "sets-phase-2-profile": (PROFILE, _SETS_PHASE_2),
    "sets-warp-0": ((), _SETS_WARP_0),
    "sets-warp-0-profile": (PROFILE, _SETS_WARP_0),
    "sets-dyn-end": ((), _SETS_DYN_END),
    "sets-padded": ((), _SETS_PADDED),
    "one-block": ((), ((WALK, "constexpr int kWideMinBlocks = 2;",
                        "constexpr int kWideMinBlocks = 1;"),
                       (WALK, "      return {fixed + rec.smem + queues, 0, "
                        "(int)slots, (int)ring, held,\n",
                        "      return {fixed + rec.smem + queues + 120000, 0, "
                        "(int)slots, (int)ring, held,\n"))),
}
# name: (nvcc flags, rewrites (source, text, replacement))
WIRING_VARIANTS = {
    "kernel": ((), ()),
    "profile": (PROFILE, ()),
    "profile-near-rows": (PROFILE, ((WIRE, "vectors + (size_t)id * D,",
                                     "vectors + (size_t)(id & 63) * D,"),)),
    "no-masks": ((), ((WIRE, "  warp_masks(s, nv, metric, lane);\n",
                       "  for (int j = lane; j < nv; j += 32) s.masks[j] = 0;"
                       "\n  __syncwarp();\n"),)),
    "no-copy": ((), ((WIRE, "      if (id >= 0)\n        bulk_copy(",
                      "      if (id >= 0 && false)\n        bulk_copy("),
                     (WIRE, "    if (lane == 0) mbar_expect(s.bar, rows * row_bytes);",
                      "    if (lane == 0) mbar_expect(s.bar, 0);"))),
}
WALK_RUNS = ("kernel", "dense", "rank1", "rank32", "rows4", "rows16",
             "threads128", "threads256", "blocks8", "blocks3",
             "sets-runtime", "widen-at-load")
# --mode wide: its builds, shapes (ef, cand_cap), batches, the crossover's
# widths, and the bytes one-block adds to its launches' shared memory (two
# blocks' worth then pass an SM's 233,472)
WIDE_BUILDS = ("kernel", "profile", "wide-from-256", "tables-to-4096",
               "one-block", "move-run-2", "move-run-8")
WIDE_SHAPES = ((2560, 2560), (4096, 4096), (4097, 64), (64, 8191),
               (5120, 5120), (8191, 8191))
WIDE_BATCHES = (64, 1024)
CROSSOVER = (320, 512, 640, 1024, 2560, 4096)
# the widest queues of each variant's table instances (its kMaxQueue)
MAX_QUEUE = {"wide-from-256": 256, "tables-to-4096": 4096}
ONE_BLOCK_PAD = 120_000
# the variants timed on the int8 rows (quantized traversal) too
INT8_RUNS = ("kernel", "widen-at-load")
# --mode pq: (G, the walk's metric, OPQ) of each PQ walk timed
PQ_CASES = ((16, 0, False), (32, 0, False), (64, 0, False), (32, 0, True),
            (32, 1, False))
# --mode records: the variants built, each placement timed (beside
# "before"): its build and what the launch asks for (walk's ``staged``:
# "forced" stages wherever records_place can, False reads the records),
# the records' element types (the API's packed_dtype) and the widths T
RECORDS_BUILDS = ("kernel", "profile", "records-cp-async", "records-prefetch",
                  "ring-prefetch", "ring-wait-first", "ring-threads128",
                  "ring-blocks3", "rows-prefetch")
RECORDS_RUNS = {"bulk copy": ("kernel", "forced"),
                "cp.async": ("records-cp-async", "forced"),
                "unstaged": ("kernel", False),
                "prefetch": ("records-prefetch", False),
                "before": ("before", False)}
# float32 records: (build, staged, the ring's rows: None, the rule's K; an
# int; or ("most", B), the most that keep B blocks an SM (None: the
# instance's WALK_MIN_BLOCKS), placed whatever the block's threads)
MOST = ("most", None)
FLOAT32_RUNS = {"kernel": ("kernel", True, None),
                "ring, most rows": ("kernel", "forced", MOST),
                "ring K=64": ("kernel", "forced", 64),
                "ring K=32": ("kernel", "forced", 32),
                "ring, L2 prefetch past K": ("ring-prefetch", "forced", MOST),
                "ring, waited first": ("ring-wait-first", "forced", MOST),
                "ring, 128 threads": ("ring-threads128", "forced", MOST),
                "ring K=61, 128 threads": ("ring-threads128", "forced", 61),
                "ring, 3 blocks an SM": ("ring-blocks3", "forced",
                                         ("most", 3)),
                "L2 prefetch, no ring": ("rows-prefetch", False, None),
                "unstaged": ("kernel", False, None),
                "before": ("before", False, None)}
RECORDS_DTYPES = ("int8", "bfloat16", "float32")
RECORDS_TS = (4, 8)
# float32 records also at T = 2 (a 128-thread block, as T = 4): the
# kernel, unstaged and before alone, no laps
FLOAT32_TS, FLOAT32_T2_RUNS = (4, 8, 2), ("kernel", "unstaged", "before")
# --mode rows: the variants built and each placement timed, as above
ROWS_BUILDS = ("kernel", "profile", "rows-phase-1", "rows-phase-1-profile",
               "rows-warp", "rows-phase-1-warp", "rows-no-fence")
ROWS_RUNS = {"processed copies": ("kernel", "forced"),
             "phase-1 copies": ("rows-phase-1", "forced"),
             "processed, warp arrivals": ("rows-warp", "forced"),
             "phase-1, warp arrivals": ("rows-phase-1-warp", "forced"),
             "processed, no proxy fence": ("rows-no-fence", "forced"),
             "unstaged": ("kernel", False),
             "before": ("before", False)}
# --mode sets: the variants built, the profile builds whose laps are
# printed, and the rows of the second index (the bitmap in shared memory)
SETS_BUILDS = ("kernel", "profile", "sets-phase-2", "sets-phase-2-profile",
               "sets-warp-0", "sets-warp-0-profile", "sets-dyn-end",
               "sets-padded")
SETS_PROFILES = ("profile", "sets-phase-2-profile", "sets-warp-0-profile",
                 "before-profile")
SETS_SMALL_N = 100_000


def prune_smem_bytes(c: int) -> int:
    """Shared memory of a scan block of two sets of ``c`` candidates, as
    csrc/prune_scan.cu's launch sizes it: the alive and kept words past
    256 candidates, none below."""
    return 0 if c <= 256 else 2 * 8 * -(-c // 32)


def variant_sources(name: str, wiring: bool = False) -> dict:
    """{source: text} of variant ``name`` (of WIRING_VARIANTS where
    ``wiring``, else of VARIANTS): the sources with its rewrites applied;
    raises ValueError where a rewrite's text is not in its source exactly
    once."""
    variants = WIRING_VARIANTS if wiring else VARIANTS
    out = {}
    for src in WIRING_SOURCES if wiring else SOURCES:
        with open(os.path.join(CSRC, src)) as f:
            text = f.read()
        for where, old, new in variants[name][1]:
            if where != src:
                continue
            if text.count(old) != 1:
                raise ValueError(f"{name}: {src} has not one {old!r}")
            text = text.replace(old, new)
        out[src] = text
    return out


def build(name: str, wiring: bool = False, sources=None, flags=None):
    """Variant ``name``'s library (of WIRING_VARIANTS where ``wiring``,
    else of VARIANTS; or, given ``sources``, those texts by file name,
    built as they are, with ``flags`` if given): its sources compiled with
    its flags added to nvcc's; returns it loaded and declared."""
    if flags is None:
        flags = () if sources else (
            WIRING_VARIANTS if wiring else VARIANTS)[name][0]
    os.makedirs(OUT, exist_ok=True)
    srcs = []
    tag = f"wiring_{name}" if wiring else name
    for src, text in (sources or variant_sources(name, wiring)).items():
        srcs.append(os.path.join(OUT, f"{tag}_{src}"))
        with open(srcs[-1], "w") as f:
            f.write(text)
    so = os.path.join(OUT, tag + ".so")
    proc = subprocess.run(
        [_kernels._nvcc(), *_kernels._NVCC_FLAGS, *flags, "-shared", "-o", so,
         *srcs], capture_output=True, text=True, env=_kernels.nvcc_env())
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    with open(so + ".log", "w") as f:
        f.write(proc.stderr)
    lib = ctypes.CDLL(so)
    if wiring:
        _kernels.declare_connect(lib)
    elif not sources:
        _kernels.declare_graph(lib)
    lib.bruteforce_topk_error_string = _kernels.load_library(
    ).bruteforce_topk_error_string
    if "-DPG_PROFILE" in flags:
        for fn in ((lib.connect_batch_profile,) if wiring else
                   (lib.beam_walk_profile, lib.prune_scan_profile)):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def build_all(names=tuple(VARIANTS), wiring: bool = False) -> dict:
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        futs = {n: ex.submit(build, n, wiring) for n in names}
        return {n: f.result() for n, f in futs.items()}


def walk(lib, graph, queries, *, ef, cand_cap, t, metric_value,
         variant="kernel", pq_table=True, staged=True, visited_slots=-1,
         visited_shared=True, ring=None, **operands):
    """One launch of ``lib``'s walk (the shared-memory figure of its
    variant) over float32 rows or the row source ``operands`` give
    (ops/cuda_graph.beam_walk's), under the dense dedupe or the visited
    set ``visited_slots``; ``pq_table`` False: a tree whose PQ
    source takes no table, laid out as the other sources are; ``staged``
    False: int8 / bf16 records read from the records (a tree that stages
    none), "forced": staged wherever they fit, whatever an SM then holds
    (True: as ops/cuda_graph._records_place chooses); ``ring``: a float32
    records ring of at most that many rows (None: the rule's);
    ``visited_shared``
    the same for a visited set (False: in device memory, as a tree before
    the sets' placement keeps it; True: as _visited_place chooses;
    "padded": in device memory, the block's shared bytes counting the set
    wherever it fits, for the sets-padded build)."""
    widest = cg.MAX_WALK_QUEUE
    cg.MAX_WALK_QUEUE = MAX_QUEUE.get(variant, widest)  # its source's layout
    blocks = cg.WALK_MIN_BLOCKS, cg.WIDE_MIN_BLOCKS
    if "forced" in (staged, visited_shared) or visited_shared == "padded":
        # no residency to keep
        cg.WALK_MIN_BLOCKS, cg.WIDE_MIN_BLOCKS = {128: 0, 256: 0}, 0
    try:
        src = cg._check_walk_args(graph, queries, ef, cand_cap, t,
                                  metric_value, visited_slots=visited_slots,
                                  **operands)
        if not pq_table:
            src = src._replace(pq=None)
        if not staged:
            src = src._replace(stage=None)
        elif ring is not None and src.stage is not None and src.stage.ring:
            src = src._replace(stage=src.stage._replace(ring=ring))
        vis = (cg._visited_words(graph, visited_slots)
               if visited_slots >= 0 else 0)
        smem, held, slots, wide, shared = cg._walk_plan(
            ef, cand_cap, t, graph.max_m, graph.dims, src.pq, graph.capacity,
            visited_slots < 0, src.stage, vis if visited_shared else 0)
        if variant == "dense":
            smem -= 4 * held + 8 * slots
        if variant == "one-block" and max(ef, cand_cap) > widest:
            smem += ONE_BLOCK_PAD
        if visited_shared == "padded":
            shared = False
        plan = cg.WalkLaunch(smem, shared, wide, 0 if shared else vis)
        return cg._launch_walk(lib, graph, queries, src, ef=ef,
                               cand_cap=cand_cap, t=t,
                               metric_value=metric_value, plan=plan,
                               visited_slots=visited_slots)
    finally:
        cg.MAX_WALK_QUEUE = widest
        cg.WALK_MIN_BLOCKS, cg.WIDE_MIN_BLOCKS = blocks


def before_layout(ef: int, cand_cap: int, t: int, max_m: int,
                  dims: int) -> tuple:
    """(shared bytes, device words a query) of the walk before its wide
    instances kept the held set (an earlier csrc/beam_walk.cu): past 4096
    the queues twice over and a held table of a power of two of at least
    2 (ef + cand_cap) ids in device memory, rebuilt each step."""
    tm, row = t * max_m, 4 * (-(-dims // 4) * 4)
    held = cg._pow2_at_least(2 * (ef + cand_cap))
    slots = cg._pow2_at_least(2 * tm)
    if max(ef, cand_cap) > 4096:
        return row + 24 * tm + 32 + 8 * slots, 4 * (ef + cand_cap) + held
    base = row + 16 * (ef + cand_cap) + 24 * tm + 32
    tables = 4 * held + 8 * slots
    return (base + tables if base + tables <= cg.SMEM_LIMIT else base), 0


def walk_before(lib, graph, queries, *, ef, cand_cap, t, metric_value):
    """One launch of the earlier tree's beam_walk (``lib``, built from its
    source) over float32 rows, dense dedupe, with its layout and its
    arguments (no row count)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.beam_walk.argtypes = [*[vp] * 9, *[ci] * 15, *[vp] * 5]
    lib.beam_walk.restype = ci
    b, dims = queries.shape
    dev = queries.device
    smem, words = before_layout(ef, cand_cap, t, graph.max_m, dims)
    out_d = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=dev)
    hops = torch.empty(b, dtype=torch.int32, device=dev)
    evals = torch.empty(b, dtype=torch.int32, device=dev)
    entry = dist_one_to_many(queries, graph.vectors[:1].expand(b, 1, dims),
                             metric_value)[:, 0].contiguous()
    wide = (torch.empty((b, words), dtype=torch.int32, device=dev)
            if words else None)
    err = lib.beam_walk(
        graph.links.data_ptr(), graph.link_counts.data_ptr(),
        graph.vectors.data_ptr(), None, None, queries.data_ptr(),
        entry.data_ptr(), None, None if wide is None else wide.data_ptr(),
        0, 0, 1, b, dims, graph.max_m, t, ef, cand_cap, metric_value, 0, -1,
        0, smem, words, out_d.data_ptr(), out_i.data_ptr(), hops.data_ptr(),
        evals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, "beam_walk (before)")
    return out_d, out_i, hops, evals


def prune(lib, args, nn):
    """One launch of ``lib``'s scan on ``args`` (d_s, valid_s, order,
    pair_d, do_prune)."""
    return cg._launch_prune(lib, *args, nn)


def _read(fn, n):
    out = (ctypes.c_ulonglong * n)()
    err = fn(ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"profile read: CUDA error {err}")
    return list(out)


def walk_phases(lib, graph, queries, **kw) -> dict:
    """The profile build's walk at ``kw``: each phase's mean cycles a
    block-step, the mean steps a block, and the walk's counters."""
    torch.cuda.synchronize()
    _read(lib.beam_walk_profile, len(WALK_PHASES) + 2)        # zero them
    got = walk(lib, graph, queries, **kw)
    torch.cuda.synchronize()
    c = _read(lib.beam_walk_profile, len(WALK_PHASES) + 2)
    steps, blocks = c[-2], c[-1]
    phases = {p: c[i] / max(steps, 1) for i, p in enumerate(WALK_PHASES)}
    phases["setup + output"] = c[0] / max(blocks, 1)           # a block
    return {"cycles": phases, "steps": steps / max(blocks, 1),
            "out": got}


def prune_phases(lib, args, nn) -> dict:
    """The profile build's scan: each phase's mean cycles a set (search
    and reject: a round), rounds a pruned set, pruned sets."""
    torch.cuda.synchronize()
    _read(lib.prune_scan_profile, len(PRUNE_PHASES) + 3)
    got = prune(lib, args, nn)
    torch.cuda.synchronize()
    c = _read(lib.prune_scan_profile, len(PRUNE_PHASES) + 3)
    rounds, sets, pruned = c[-3], c[-2], c[-1]
    phases = {p: c[i] / max(sets, 1) for i, p in enumerate(PRUNE_PHASES)}
    for p in ("search", "reject"):
        phases[p] = c[PRUNE_PHASES.index(p)] / max(rounds, 1)
    return {"cycles": phases, "rounds": rounds / max(pruned, 1),
            "pruned": pruned, "sets": sets, "out": got}


def capture_wiring(idx, rows) -> tuple:
    """The operands of the wiring of ``idx.add(rows)``: (vectors, links,
    counts as they were before it, base, kept_i, kept_cnt, n_insert, the
    keyword arguments of core/build._connect_batch)."""
    from .core import build as core_build
    real, seen = core_build._connect_batch, []

    def spy(vectors, links, counts, base, kept_i, kept_cnt, n_insert, **kw):
        seen.append((vectors, links.clone(), counts.clone(), base,
                     kept_i.clone(), kept_cnt.clone(), n_insert, kw))
        return real(vectors, links, counts, base, kept_i, kept_cnt,
                    n_insert, **kw)
    core_build._connect_batch = spy
    try:
        idx.add(rows)
    finally:
        core_build._connect_batch = real
    return seen[0]


def wiring_batches(wiring) -> dict:
    """{name: (links, counts, operands, touched rows)}: the add()'s batch
    as captured; an appends-only one (the same ops with every non-member
    target's count at 0, so no chain re-prunes); and a re-prunes-only one
    (the ops of the chains that re-prune, the rest invalid: the same
    re-prunes with no other chain beside them)."""
    from .core import build as core_build
    vectors, links, counts, base, kept_i, kept_cnt, n_insert, kw = wiring
    keys, perm = core_build._chain_order(core_build._back_link_targets(
        kept_i, kept_cnt, n_insert, m=kw["m"]))
    members = torch.arange(base, base + n_insert, device=keys.device)
    targets = torch.unique(keys[keys != core_build.NO_TARGET]).long()
    touched = torch.unique(torch.cat([targets, members]))
    appends = counts.clone()
    appends[targets[(targets < base) | (targets >= base + n_insert)]] = 0
    ops = (vectors, keys, perm, kept_i, kept_cnt,
           dict(kw, base=base, n_insert=n_insert))
    # the counts the chains start from (a member's: its forward row's)
    fwd = counts.clone()
    core_build._forward_links(links.clone(), fwd, base, kept_i, kept_cnt,
                              n_insert, m=kw["m"], max_m=kw["max_m"])
    heavy, length = torch.unique(keys[keys != core_build.NO_TARGET],
                                 return_counts=True)
    heavy = heavy[fwd[heavy.long()] + length > kw["max_m"]]
    only = torch.where(torch.isin(keys, heavy), keys, core_build.NO_TARGET)
    only, order = torch.sort(only, stable=True)
    reprunes = (vectors, only, perm[order], kept_i, kept_cnt,
                dict(kw, base=base, n_insert=n_insert))
    return {"add()": (links, counts, ops, touched),
            "appends only": (links, appends, ops, touched),
            "re-prunes only": (links, counts, reprunes, touched)}


def wire(lib, links, counts, ops):
    """One launch of ``lib``'s connect_batch on ``links`` / ``counts`` (in
    place) with the captured operands ``ops``."""
    vectors, keys, perm, kept_i, kept_cnt, kw = ops
    cg._launch_connect(lib, vectors, links, counts, keys, perm, kept_i,
                       kept_cnt, **kw)


def wiring_phases(lib, links, counts, ops, restore) -> dict:
    """The profile build's warp-tier laps on one launch on ``links`` /
    ``counts`` after ``restore()`` (a first launch warms the caches as the
    timed launches find them): each phase's mean cycles a chain (head, row,
    write) or a re-prune (stage, d, ranks, masks, scan), the chains and
    re-prunes, the longest chain's cycles."""
    restore()
    wire(lib, links, counts, ops)
    restore()
    torch.cuda.synchronize()
    _read(lib.connect_batch_profile, len(WIRING_PHASES) + 3)   # zero them
    wire(lib, links, counts, ops)
    torch.cuda.synchronize()
    c = _read(lib.connect_batch_profile, len(WIRING_PHASES) + 3)
    chains, reprunes, longest = c[-3], c[-2], c[-1]
    per = {p: c[i] / max(reprunes if 2 <= i <= 6 else chains, 1)
           for i, p in enumerate(WIRING_PHASES)}
    return {"cycles": per, "chains": chains, "reprunes": reprunes,
            "longest": longest}


def wiring_main(args) -> int:
    """--mode wiring: the wiring variants on one add()'s batch and an
    appends-only one (see the module's note)."""
    from . import HnswConfig, HnswIndex
    from .utils.io import synthetic_clustered
    libs = build_all(tuple(WIRING_VARIANTS), wiring=True)
    for name in libs:
        with open(os.path.join(OUT, f"wiring_{name}.so.log")) as f:
            for line in f:
                if "Compiling entry" in line or "Used" in line \
                        or "spill" in line:
                    print(f"ptxas wiring {name}: {line.strip()}")
    pts, qs = synthetic_clustered(args.n, 128, 1_000, seed=12345,
                                  n_queries=1024)
    idx = HnswIndex(HnswConfig(dims=128, m=16, ef_construction=64,
                               ef_search=64), device="cuda")
    idx.build(pts)
    rng = np.random.default_rng(12352)
    rows = (qs[:idx.max_insert_batch] + rng.normal(
        scale=0.1, size=(idx.max_insert_batch, 128))).astype(np.float32)
    batches = wiring_batches(capture_wiring(idx, rows))
    for bname, (links, counts, ops, touched) in batches.items():
        timed = ("kernel", "no-masks", "no-copy")
        start_rows, start_counts = links[touched].clone(), counts[touched]
        work_links, work_counts = links.clone(), counts.clone()

        def restore():
            work_links[touched] = start_rows
            work_counts[touched] = start_counts
        want = None
        for name in timed:
            restore()
            wire(libs[name], work_links, work_counts, ops)
            got = work_links[touched].clone(), work_counts[touched].clone()
            want = want or got
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"wiring {bname} {name}: rows and counts equal to the "
                  f"kernel's: {same}")
        ms = {n: [] for n in timed}
        for name in (*timed, *reversed(timed)):
            ms[name].append(
                device_ms(lambda: (restore(), wire(libs[name], work_links,
                                                   work_counts, ops)),
                          args.reps)
                - device_ms(restore, args.reps))
        shape = cg.LAST_CONNECT_LAUNCH
        for name in timed:
            print(f"wiring {bname} {name} ({shape.tier} tier, "
                  f"{shape.blocks} blocks of {shape.threads} threads, "
                  f"{shape.smem} bytes of shared memory a block; ms on the "
                  f"card, in turns): "
                  + " / ".join(f"{m:.4f}" for m in ms[name]), flush=True)
        for name in ("profile", "profile-near-rows"):
            r = wiring_phases(libs[name], work_links, work_counts, ops,
                              restore)
            print(f"wiring {bname} {name} ({r['chains']} chains, "
                  f"{r['reprunes']} re-prunes; cycles a chain: head, row, "
                  f"write; a re-prune: stage, d, ranks, masks, scan; the "
                  f"longest chain {r['longest']:,} cycles): "
                  f"{format_cycles(r['cycles'])}", flush=True)
    return 0


def wide_main(args) -> int:
    """--mode wide: the walk's wide instances against the earlier tree's
    and at one block an SM, then the crossover (see the module's note)."""
    from . import HnswConfig, HnswIndex
    from .utils.io import synthetic_clustered
    libs = build_all(WIDE_BUILDS)
    if args.before:
        with open(args.before) as f:
            text = f.read()
        with open(os.path.join(CSRC, SCAN)) as f:
            libs["before"] = build("before", sources={WALK: text,
                                                      SCAN: f.read()})
    for name in libs:
        with open(os.path.join(OUT, name + ".so.log")) as f:
            fn = None
            for line in f:
                if "Compiling entry" in line:
                    fn = line.split("'")[1]
                elif fn and "beam_walk" in fn and ("Used" in line
                                                   or "spill" in line):
                    print(f"ptxas {name} {fn}: {line.strip()}")
    pts, qs = synthetic_clustered(args.n, 128, 1_000, seed=12345,
                                  n_queries=1024)
    idx = HnswIndex(HnswConfig(dims=128, m=16, ef_construction=64,
                               ef_search=64), device="cuda")
    idx.build(pts)
    g, q_all = idx.graph, torch.as_tensor(qs, device="cuda")

    def run(name, q, kw):
        if name == "before":
            return walk_before(libs[name], g, q, **kw)
        return walk(libs[name], g, q, variant=name, **kw)

    def timed(names, q, kw, label):
        want = run("kernel", q, kw)
        for name in names:
            got = run(name, q, kw)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"{label} {name}: ids, distances, hops and evals equal to "
                  f"the kernel's: {same}", flush=True)
        ms = {n: [] for n in names}
        for name in (*names, *names[::-1]):
            ms[name].append(device_ms(lambda: run(name, q, kw), args.reps))
        hops = float(want[2].float().mean())
        for name in names:
            print(f"{label} {name} ({hops:.1f} hops a query; ms on the "
                  f"card, in turns): "
                  + " / ".join(f"{m:.3f}" for m in ms[name]), flush=True)

    for b in WIDE_BATCHES:
        q = q_all[:b]
        for ef, cap in WIDE_SHAPES:
            kw = dict(ef=ef, cand_cap=cap, t=8, metric_value=0)
            names = ["kernel", *(["before"] if "before" in libs else []),
                     *(["one-block", "move-run-2", "move-run-8"]
                       if (ef, cap) == (5120, 5120) else [])]
            smem = cg._walk_smem_bytes(ef, cap, 8, g.max_m, g.dims, None)
            label = (f"wide B={b} ef={ef} cand_cap={cap} T=8 ({smem} bytes "
                     f"of shared memory a block)")
            timed(names, q, kw, label)
            r = walk_phases(libs["profile"], g, q, **kw)
            print(f"{label} profile cycles a block-step "
                  f"({r['steps']:.2f} steps a block): "
                  f"{format_cycles(r['cycles'])}", flush=True)
    for b in WIDE_BATCHES:
        for ef in CROSSOVER:
            kw = dict(ef=ef, cand_cap=ef, t=8, metric_value=0)
            other = ("wide-from-256" if ef <= cg.MAX_WALK_QUEUE
                     else "tables-to-4096")
            timed(["kernel", other], q_all[:b], kw,
                  f"crossover B={b} ef=cand_cap={ef} T=8")
    return 0


def pq_libs(args) -> dict:
    """--mode pq's builds: the kernel and its profile build, and with
    ``--before`` the earlier tree's source built both ways (this tree's
    scan beside it); each library's PQ instances' ptxas lines printed."""
    builds = {n: (build, (n,), {}) for n in ("kernel", "profile")}
    if args.before:
        with open(args.before) as f:
            text = f.read()
        with open(os.path.join(CSRC, SCAN)) as f:
            sources = {WALK: text, SCAN: f.read()}
        builds["before"] = (build, ("before",), dict(sources=sources))
        builds["before-profile"] = (build, ("before-profile",), dict(
            sources=sources, flags=PROFILE))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        futs = {n: ex.submit(fn, *a, **kw) for n, (fn, a, kw)
                in builds.items()}
        libs = {n: f.result() for n, f in futs.items()}
    for name, lib in libs.items():
        if name.startswith("before"):
            _kernels.declare_graph(lib)
        with open(os.path.join(OUT, name + ".so.log")) as f:
            fn = None
            for line in f:
                if "Compiling entry" in line:
                    fn = line.split("'")[1]
                elif (fn and re.search(r"beam_walk(_wide)?_kernelILi[34]E",
                                       fn)
                      and ("Used" in line or "spill" in line)):
                    print(f"ptxas {name} {fn}: {line.strip()}", flush=True)
    return libs


def twin_bar(got, want, graph, queries, metric_value, rerank, truth):
    """chip_smoke.py's bar of a walk against its twin: (recall@10 of each
    after finish_walk against ``truth``, queries whose ids differ, mean
    hops and dist_evals of each) and whether it holds (recall within
    0.002, ids on >= 98% of queries, hops and evals within 1%)."""
    from .core import search as core_search
    fin = dict(metric_value=metric_value, hashed=False, rerank=rerank)
    ki = core_search.finish_walk(graph, queries, *got[:2], **fin)[1]
    pi = core_search.finish_walk(graph, queries, *want[:2], **fin)[1]

    def recall(ids):
        ids = ids[:, :truth.shape[1]].cpu().numpy()
        return float(np.mean([len(set(a) & set(b)) / truth.shape[1]
                              for a, b in zip(ids, truth)]))
    rk, rp = recall(ki), recall(pi)
    n_diff = int((~(ki == pi).all(dim=1)).sum())
    hk, hp = (float(x[2].float().mean()) for x in (got, want))
    ek, ep = (float(x[3].float().mean()) for x in (got, want))
    held = (abs(rk - rp) <= 0.002 and n_diff <= 0.02 * len(ki)
            and abs(hk - hp) <= 0.01 * hp and abs(ek - ep) <= 0.01 * ep)
    return (rk, rp, n_diff, hk, hp, ek, ep), held


def pq_main(args) -> int:
    """--mode pq: the PQ walk's instances against the earlier tree's, the
    twin and the float32 rows' walks (see the module's note)."""
    from . import HnswConfig, HnswIndex
    from .core import search as core_search
    from .ops.cuda_bruteforce import fused_exact_search
    from .ops.distance import _matmul
    from .utils.io import synthetic_clustered
    libs = pq_libs(args)
    before = "before" in libs
    pts, qs = synthetic_clustered(args.n, 128, 1_000, seed=12345,
                                  n_queries=1024)
    idx = HnswIndex(HnswConfig(dims=128, m=16, ef_construction=64,
                               ef_search=64), device="cuda")
    idx.build(pts)
    del pts
    g, q = idx.graph, torch.as_tensor(qs, device="cuda")
    ok = True

    def timed(label, kw, names):
        ms = {n: [] for n in names}
        for name in (*names, *names[::-1]):
            ms[name].append(device_ms(lambda: walk(
                libs[name], g, q, **kw, pq_table=name != "before"),
                args.reps))
        for name in names:
            print(f"{label} {name} (ms on the card, in turns): "
                  + " / ".join(f"{m:.4f}" for m in ms[name]), flush=True)

    for t in (4, 8):
        kw = dict(ef=64, cand_cap=64, t=t, metric_value=0)
        timed(f"f32 rows T={t}", kw, ["kernel", *(["before"] * before)])
    truths = {}
    for groups, metric, opq in PQ_CASES:
        if (groups, opq) != (idx.pq_groups, idx.pq_opq) or \
                idx._pq_codebook is None:
            idx.pq_groups, idx.pq_opq = groups, opq
            idx._pq_codebook = idx._pq_rot = idx._pq_codes = None
            idx._pcodes = None
            idx.packed_traversal, idx.packed_dtype = True, "pq"
            idx._ensure_pq_codebook()
            idx._ensure_pq_codes()
            idx._ensure_packed()
        ops = dict(records=idx._pcodes, pq_codebook=idx._pq_codebook)
        if opq:
            ops["query_t"] = _matmul(q, idx._pq_rot)
        kw = dict(ef=64, cand_cap=64, t=8, metric_value=metric, **ops)
        smem = cg._walk_smem_bytes(64, 64, 8, g.max_m, g.dims,
                                   cg.PqTable(groups, metric))
        label = (f"pq G={groups}{' OPQ' if opq else ''} "
                 f"{('L2', 'cosine', 'Manhattan')[metric]} T=8 ef=64 "
                 f"({smem} bytes of shared memory a block)")
        got = walk(libs["kernel"], g, q, **kw)
        if before:
            old = walk(libs["before"], g, q, pq_table=False, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got, old))
            print(f"{label}: ids, distances, hops and evals equal to the "
                  f"earlier tree's: {same}", flush=True)
            ok &= same or groups != 32
        if metric not in truths:
            truths[metric] = fused_exact_search(
                q, g.vectors, 10, metric=metric,
                n_valid=g.n_nodes)[1].cpu().numpy()
        want = core_search._search_batch(
            g, q, ef=64, metric_value=metric, cand_cap=64, expand_width=8,
            pcodes=ops["records"], pq_codebook=ops["pq_codebook"],
            query_t=ops.get("query_t"))
        (rk, rp, n_diff, hk, hp, ek, ep), held = twin_bar(
            got, want, g, q, metric, True, truths[metric])
        print(f"{label} vs the twin: recall@10 {rk:.4f} / {rp:.4f}; ids "
              f"differ on {n_diff} of {len(q)} queries; hops {hk:.2f} / "
              f"{hp:.2f}, dist_evals {ek:.1f} / {ep:.1f}; the bar holds: "
              f"{held}", flush=True)
        ok &= held
        timed(label, kw, ["kernel", *(["before"] * before)])
        for name in ("profile", *(["before-profile"] * before)):
            r = walk_phases(libs[name], g, q, **kw,
                            pq_table=name != "before-profile")
            print(f"{label} {name} cycles a block-step "
                  f"({r['steps']:.2f} steps a block; setup: a block): "
                  f"{format_cycles(r['cycles'])}", flush=True)
    print(f"pq: every check held: {ok}", flush=True)
    return 0 if ok else 1


def walk_blocks(lib, elem: int, staged: bool, t: int, max_m: int,
                smem: int, dense: bool = True, wide: bool = False) -> int:
    """Blocks an SM holds at once of the walk instance ``lib`` launches
    for rows of element type ``elem`` (ops/cuda_graph's codes; int8 / bf16
    records ``staged`` or not) at T = ``t`` and ``smem`` bytes a block:
    the runtime's occupancy of the built kernel (beam_walk_blocks)."""
    n = lib.beam_walk_blocks(elem, int(staged), int(dense), int(wide), t,
                             max_m, smem)
    if n < 0:
        raise RuntimeError(f"beam_walk_blocks failed for elem {elem}, "
                           f"T={t}, {smem} bytes")
    return n


def ptxas_reports(log: str) -> dict:
    """{mangled kernel name: (registers, ptxas's spill line)} from a build's
    compiler report."""
    out, fn, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m[1]
        elif fn and "spill" in line:
            spill = re.sub(r"^ptxas\s+info\s*:\s*", "", line.strip())
        elif fn and "Used" in line:
            out[fn] = (int(re.search(r"Used (\d+) registers", line)[1]), spill)
            fn, spill = None, ""
    return out


def placement_libs(args, names) -> dict:
    """--mode records' or rows' builds: ``names`` and, with ``--before``,
    the earlier tree's source built as it is and profiled (this tree's
    scan beside it)."""
    builds = {n: (build, (n,), {}) for n in names}
    if args.before:
        with open(args.before) as f:
            text = f.read()
        with open(os.path.join(CSRC, SCAN)) as f:
            sources = {WALK: text, SCAN: f.read()}
        builds["before"] = (build, ("before",), dict(sources=sources))
        builds["before-profile"] = (build, ("before-profile",), dict(
            sources=sources, flags=PROFILE))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        futs = {n: ex.submit(fn, *a, **kw) for n, (fn, a, kw)
                in builds.items()}
        libs = {n: f.result() for n, f in futs.items()}
    for name in libs:
        if name.startswith("before"):
            _kernels.declare_graph(libs[name])
    return libs


def _records_cases(idx, g):
    """--mode records' walks: (label, graph, the wrapper's operands, the
    twin's, rerank) of each records type, packed by the index."""
    for dtype in RECORDS_DTYPES:
        idx.packed_traversal, idx.packed_dtype = True, dtype
        records, scales = idx._ensure_packed()
        ops = dict(records=records)
        if scales is not None:
            ops["pscales"] = scales
        yield (f"records {dtype}", g, ops,
               dict(pcodes=records, pscales=scales), True)
        idx._pcodes = idx._pscales = None
        idx.packed_traversal = False


def _rows_cases(idx, g):
    """--mode rows' walks: the int8 rows x scales of the quantized
    traversal, then the index's rows as bf16 (downcast_corpus's)."""
    import dataclasses
    qv, qsc = idx._ensure_quantized()
    ops = dict(qvectors=qv, qscale=qsc)
    yield "rows int8", g, ops, ops, True
    gb = dataclasses.replace(g, vectors=g.vectors.to(torch.bfloat16))
    yield "rows bf16", gb, {}, {}, False


def placements_main(args, rows: bool) -> int:
    """--mode records or rows: the int8 and bf16 records (or rows) walks'
    placements against the earlier tree's, the twin and the float32 rows'
    walks (see the module's note)."""
    from . import HnswConfig, HnswIndex
    from .core import search as core_search
    from .ops.cuda_bruteforce import fused_exact_search
    from .utils.io import synthetic_clustered
    libs = placement_libs(args, ROWS_BUILDS if rows else RECORDS_BUILDS)
    before = "before" in libs
    reports = {}
    for name in libs:
        with open(os.path.join(OUT, name + ".so.log")) as f:
            reports[name] = ptxas_reports(f.read())
        for fn, (regs, spill) in sorted(reports[name].items()):
            # the int8 / bf16 instances, staged (5, 6) or not (1, 2), the
            # float32 ones (0) and the ring's (7)
            if re.search(r"beam_walk(_wide)?_kernelILi[012567]E", fn):
                print(f"ptxas {name} {fn}: {regs} registers; {spill}",
                      flush=True)
    pts, qs = synthetic_clustered(args.n, 128, 1_000, seed=12345,
                                  n_queries=1024)
    idx = HnswIndex(HnswConfig(dims=128, m=16, ef_construction=64,
                               ef_search=64), device="cuda")
    idx.build(pts)
    del pts
    g, q = idx.graph, torch.as_tensor(qs, device="cuda")
    truth = fused_exact_search(q, g.vectors, 10, metric=0,
                               n_valid=g.n_nodes)[1].cpu().numpy()
    ok = True

    runs = ROWS_RUNS if rows else RECORDS_RUNS

    def run(name, graph, kw):
        """Placement ``name`` of the mode's runs, or "kernel": the
        kernel's build at the placement _records_place chooses."""
        lib, staged, *ring = runs.get(name, ("kernel", True))
        ring = ring[0] if ring else None
        if isinstance(ring, tuple):
            ring = most_rows(kw["t"], ring[1])
        return walk(libs[lib], graph, q, **kw, staged=staged, ring=ring)

    def most_rows(t, blocks):
        """The most rows a float32 records ring keeps at T = ``t`` with
        ``blocks`` blocks an SM (None: the instance's WALK_MIN_BLOCKS),
        whatever the block's threads."""
        return cg._ring_rows(
            cg.RecordsStage(4, False, True, False, t * g.max_m), g.dims,
            cg._walk_smem_bytes(64, 64, t, g.max_m, g.dims, None),
            blocks or cg.WALK_MIN_BLOCKS[cg._walk_threads(t, g.max_m)])

    def timed(label, graph, kw, names):
        ms = {n: [] for n in names}
        for name in (*names, *names[::-1]) * args.turns:
            ms[name].append(device_ms(lambda: run(name, graph, kw),
                                      args.reps))
        for name in names:
            print(f"{label} {name} (ms on the card, in turns): "
                  + " / ".join(f"{m:.4f}" for m in ms[name]), flush=True)

    profiles = ["profile", *(["rows-phase-1-profile"] * rows),
                *(["before-profile"] * before)]
    for t in RECORDS_TS:
        kw = dict(ef=64, cand_cap=64, t=t, metric_value=0)
        timed(f"f32 rows T={t}", g, kw, ["kernel", *(["before"] * before)])
        for name in ("profile", *(["before-profile"] * before)):
            r = walk_phases(libs[name], g, q, **kw)
            print(f"f32 rows T={t} {name} cycles a block-step "
                  f"({r['steps']:.2f} steps a block; setup: a block): "
                  f"{format_cycles(r['cycles'])}", flush=True)
    cases = _rows_cases(idx, g) if rows else _records_cases(idx, g)
    for source, graph, ops, twin_ops, rerank in cases:
        f32 = source == "records float32"
        runs = FLOAT32_RUNS if f32 else (ROWS_RUNS if rows else RECORDS_RUNS)
        for t in FLOAT32_TS if f32 else RECORDS_TS:
            names = [n for n in runs if (before or n != "before") and (
                t in RECORDS_TS or n in FLOAT32_T2_RUNS)]
            kw = dict(ef=64, cand_cap=64, t=t, metric_value=0, **ops)
            src = cg._check_walk_args(graph, q, 64, 64, t, 0, **ops)
            stage, elem = src.stage, src.elem
            staged = cg.records_staging(64, 64, t, g.max_m, g.dims, stage)
            plain = cg._walk_smem_bytes(64, 64, t, g.max_m, g.dims, None)
            rec, _ = cg._records_place(stage, t, g.max_m, g.dims, plain, 0)
            if staged and stage.ring:
                rec = staged                # the ring at the rule's K
            blocks = [walk_blocks(libs["kernel"], elem, on, t, g.max_m,
                                  plain + rec * on) for on in (True, False)]
            ring = (f", a ring of {rec // (4 * g.dims)} rows"
                    if stage is not None and stage.ring else "")
            label = (f"{source} T={t} ef=64 (staged: {plain + rec} bytes "
                     f"of shared memory a block, {rec} of them the rows"
                     f"{ring}, {blocks[0]} blocks an SM; unstaged: {plain} "
                     f"bytes, {blocks[1]} blocks an SM; the kernel takes "
                     f"{'staged' if staged else 'unstaged'})")
            got = run("kernel", graph, kw)
            for name in names:
                same = all(torch.equal(a, b)
                           for a, b in zip(run(name, graph, kw), got))
                print(f"{label} {name}: ids, distances, hops and evals "
                      f"equal to the kernel's: {same}", flush=True)
                ok &= same
            want = core_search._search_batch(
                graph, q, ef=64, metric_value=0, cand_cap=64,
                expand_width=t, **twin_ops)
            (rk, rp, n_diff, hk, hp, ek, ep), held = twin_bar(
                got, want, graph, q, 0, rerank, truth)
            print(f"{label} vs the twin: recall@10 {rk:.4f} / {rp:.4f}; "
                  f"ids differ on {n_diff} of {len(q)} queries; hops "
                  f"{hk:.2f} / {hp:.2f}, dist_evals {ek:.1f} / {ep:.1f}; "
                  f"the bar holds: {held}", flush=True)
            ok &= held
            if not rerank and not rows:
                # float32 records: the twin's walk on every query
                same = ((got[1] == want[1]).all(dim=1) & (got[2] == want[2])
                        & (got[3] == want[3]))
                print(f"{label} vs the twin: ids, hops and evals equal on "
                      f"{int(same.sum())} of {len(q)} queries", flush=True)
                ok &= bool(same.all())
            timed(label, graph, kw, names)
            laps = [(name, dict(staged="forced" if name.startswith("rows")
                                else name != "before-profile"))
                    for name in profiles * (t in RECORDS_TS)]
            if f32 and t in RECORDS_TS and not staged:
                # the ring the rule declines, forced at its most rows
                laps.append(("profile", dict(staged="forced",
                                             ring=most_rows(t, None))))
            for name, place in laps:
                r = walk_phases(libs[name], graph, q, **kw, **place)
                forced = (f" (a ring of {place['ring']} rows forced)"
                          if "ring" in place else "")
                print(f"{label} {name}{forced} cycles a block-step "
                      f"({r['steps']:.2f} steps a block; setup: a block): "
                      f"{format_cycles(r['cycles'])}", flush=True)
    print(f"{'rows' if rows else 'records'}: every check held: {ok}",
          flush=True)
    return 0 if ok else 1


def sets_cases(n: int, small: bool):
    """--mode sets' walks on an index of ``n`` rows: (label, visited_slots,
    ef = cand_cap, T, queries) of each timed walk.  On the main index: the
    hash set at 8,192 slots (the API's at ef 64) and 16,384 (at ef 128)
    and the bitmap, at T = 4 and 8 (16,384 at T = 8), then both sets in
    the wide instances at ef 5,120 on 64 queries; on the small index, the
    bitmap at T = 4 and 8."""
    if small:
        for t in (4, 8):
            yield f"bitmap, {n} rows, T={t}", 0, 64, t, 1024
        return
    for t in (4, 8):
        yield f"hash 8192, T={t}", 8192, 64, t, 1024
    yield "hash 16384, ef=128, T=8", 16384, 128, 8, 1024
    for t in (4, 8):
        yield f"bitmap, {n} rows, T={t}", 0, 64, t, 1024
    for slots in (0, 8192):
        yield (f"{'hash 8192' if slots else 'bitmap'} wide, ef=5120, T=8",
               slots, 5120, 8, 64)


def sets_main(args) -> int:
    """--mode sets: the bitmap and hash sets' walks against the earlier
    tree's, the twin and the dense float32 rows' walks (see the module's
    note)."""
    from . import HnswConfig, HnswIndex
    from .core import search as core_search
    from .utils.io import synthetic_clustered
    libs = placement_libs(args, SETS_BUILDS)
    before = "before" in libs
    for name in libs:
        with open(os.path.join(OUT, name + ".so.log")) as f:
            reports = ptxas_reports(f.read())
        for fn, (regs, spill) in sorted(reports.items()):
            # the float32 rows' instances: dense (Lb1E), the sets' (Lb0E),
            # the wide one
            if re.search(r"beam_walk(_kernelILi0ELb[01]E|_wide_kernelILi0E)",
                         fn):
                print(f"ptxas {name} {fn}: {regs} registers; {spill}",
                      flush=True)
    ok = True
    for n, small in ((args.n, False), (SETS_SMALL_N, True)):
        pts, qs = synthetic_clustered(n, 128, 1_000, seed=12345,
                                      n_queries=1024)
        idx = HnswIndex(HnswConfig(dims=128, m=16, ef_construction=64,
                                   ef_search=64), device="cuda")
        idx.build(pts)
        del pts
        g, q_all = idx.graph, torch.as_tensor(qs, device="cuda")
        if not small:
            for t in (4, 8):
                kw = dict(ef=64, cand_cap=64, t=t, metric_value=0)
                names = ["kernel", *(["before"] * before)]
                ms = {m: [] for m in names}
                for m in (*names, *names[::-1]):
                    ms[m].append(device_ms(lambda: walk(libs[m], g, q_all,
                                                        **kw), args.reps))
                for m in names:
                    print(f"f32 rows dense T={t} {m} (ms on the card, in "
                          f"turns): " + " / ".join(f"{x:.4f}" for x in ms[m]),
                          flush=True)
        for label, slots, ef, t, b in sets_cases(n, small):
            q = q_all[:b]
            kw = dict(ef=ef, cand_cap=ef, t=t, metric_value=0,
                      visited_slots=slots)
            words = cg._visited_words(g, slots)
            shared = cg._walk_plan(ef, ef, t, g.max_m, g.dims, None,
                                   g.capacity, False, None, words)[4]
            plain = cg._walk_smem_bytes(ef, ef, t, g.max_m, g.dims, None)
            wide = ef > cg.MAX_WALK_QUEUE
            # the set's bytes where it fits a table instance's block,
            # whatever an SM then holds
            room = 0 if wide else cg._visited_place(words, plain, 0)[0]
            # each run: (library, visited_shared)
            runs = {"kernel": ("kernel", True),
                    "phase-2 reads": ("sets-phase-2", True)}
            if slots:
                runs["warp-0 writes"] = ("sets-warp-0", True)
            if shared:
                runs["device forced"] = ("kernel", False)
            elif room:
                runs["shared forced"] = ("kernel", "forced")
            if room:
                runs["device, padded"] = ("sets-padded", "padded")
            if not wide:
                runs["end of dynamic smem"] = ("sets-dyn-end", shared)
            if before:
                runs["before"] = ("before", False)
            blocks = {
                s: walk_blocks(libs["kernel"], 0, False, t, g.max_m, smem,
                               dense=False, wide=wide)
                for s, smem in ((True, plain + room), (False, plain))}
            where = "shared" if shared else "device memory"
            label = (f"{label} ({words} words a query, kept in {where}; "
                     f"{plain} bytes of shared memory a block without the "
                     f"set, {blocks[False]} blocks an SM"
                     + (f"; {plain + room} with it, {blocks[True]}"
                        if room else "") + ")")
            got = {m: walk(libs[lib], g, q, **kw, visited_shared=vs)
                   for m, (lib, vs) in runs.items()}
            for m, out in got.items():
                same = all(torch.equal(a, c)
                           for a, c in zip(out, got["kernel"]))
                print(f"{label} {m}: ids, distances, hops and evals equal to "
                      f"the kernel's: {same}", flush=True)
                ok &= same
            if b == 1024 and t == 8:
                want = core_search._search_batch(
                    g, q, ef=ef, metric_value=0, cand_cap=ef, expand_width=t,
                    visited_slots=slots)
                same = ((got["kernel"][1] == want[1]).all(dim=1)
                        & (got["kernel"][2] == want[2])
                        & (got["kernel"][3] == want[3]))
                print(f"{label} vs the twin: ids, hops and evals equal on "
                      f"{int(same.sum())} of {b} queries", flush=True)
            fill = device_ms(lambda: cg._device_visited(
                b, words, slots, True, q.device), args.reps)
            print(f"{label}: the wrapper's fill of a device set "
                  f"{fill:.4f} ms on the card", flush=True)
            ms = {m: [] for m in runs}
            for m in (*runs, *list(runs)[::-1]) * args.turns:
                lib, vs = runs[m]
                ms[m].append(device_ms(lambda: walk(
                    libs[lib], g, q, **kw, visited_shared=vs), args.reps))
            hops = float(got["kernel"][2].float().mean())
            for m in runs:
                print(f"{label} {m} ({hops:.2f} hops a query; ms on the "
                      f"card, in turns): "
                      + " / ".join(f"{x:.4f}" for x in ms[m]), flush=True)
            for name in SETS_PROFILES:
                if name not in libs:
                    continue
                r = walk_phases(libs[name], g, q, **kw,
                                visited_shared=name != "before-profile")
                print(f"{label} {name} cycles a block-step "
                      f"({r['steps']:.2f} steps a block; setup: a block): "
                      f"{format_cycles(r['cycles'])}", flush=True)
        del idx, g, q_all
        torch.cuda.empty_cache()
    print(f"sets: every check held: {ok}", flush=True)
    return 0 if ok else 1


def format_cycles(cycles: dict) -> str:
    return ", ".join(f"{k} {v:,.0f}" for k, v in cycles.items())


def device_ms(fn, reps: int = 20) -> float:
    """The card's time for one call of ``fn``: ``reps`` calls captured in
    a CUDA graph and replayed between CUDA events (median of 5 replays,
    after a warm one), so the host's time to launch them is not counted.
    ``fn`` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del graph
    return float(np.median(times))


def capture_prunes(idx, rows) -> dict:
    """The inputs of the first prune_scan of each candidate width during
    ``idx.add(rows)``: {C: (d_s, valid_s, order, pair_d, do_prune, nn)}."""
    from .core import build as core_build
    real, seen = core_build.prune_scan, {}

    def spy(*args):
        seen.setdefault(args[0].shape[1], tuple(
            a.clone() if hasattr(a, "clone") else a for a in args))
        return real(*args)
    core_build.prune_scan = spy
    try:
        idx.add(rows)
    finally:
        core_build.prune_scan = real
    return seen


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=None,
                    help="calls a CUDA graph replays (20; --mode wide 3)")
    ap.add_argument("--mode", choices=("walk", "wiring", "wide", "pq",
                                       "records", "rows", "sets"),
                    default="walk")
    ap.add_argument("--before", help="--mode wide / pq / records / rows / "
                    "sets: an "
                    "earlier tree's csrc/beam_walk.cu, timed beside the "
                    "kernel")
    ap.add_argument("--turns", type=int, default=1,
                    help="--mode sets / records / rows: rounds of timings "
                    "in turns (each in order, then reversed)")
    args = ap.parse_args()
    if args.reps is None:
        args.reps = 3 if args.mode == "wide" else 20
    if not torch.cuda.is_available():
        raise SystemExit("graph_probe: no CUDA device")
    from . import HnswConfig, HnswIndex
    from .utils.io import synthetic_clustered
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.mode == "wiring":
        return wiring_main(args)
    if args.mode == "wide":
        return wide_main(args)
    if args.mode == "pq":
        return pq_main(args)
    if args.mode in ("records", "rows"):
        return placements_main(args, args.mode == "rows")
    if args.mode == "sets":
        return sets_main(args)
    libs = build_all(tuple(n for n in VARIANTS
                           if n not in WIDE_BUILDS + RECORDS_BUILDS
                           + ROWS_BUILDS + SETS_BUILDS
                           or n in ("kernel", "profile")))
    for name in libs:
        with open(os.path.join(OUT, name + ".so.log")) as f:
            for line in f:
                if "Used" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")
    pts, qs = synthetic_clustered(args.n, 128, 1_000, seed=12345,
                                  n_queries=1024)
    idx = HnswIndex(HnswConfig(dims=128, m=16, ef_construction=64,
                               ef_search=64), device="cuda")
    idx.build(pts)
    rng = np.random.default_rng(12352)
    rows = (qs[:idx.max_insert_batch] + rng.normal(
        scale=0.1, size=(idx.max_insert_batch, 128))).astype(np.float32)
    sets = capture_prunes(idx, rows)
    g, q = idx.graph, torch.as_tensor(qs, device="cuda")
    for t in (4, 8):
        kw = dict(ef=64, cand_cap=64, t=t, metric_value=0)
        want = walk(libs["kernel"], g, q, **kw)
        for n in WALK_RUNS:
            got = walk(libs[n], g, q, variant=n, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
            print(f"walk T={t} {n}: ids, hops and evals equal to the "
                  f"kernel's: {same}")
        ms = {n: [] for n in WALK_RUNS}
        for n in WALK_RUNS + WALK_RUNS[::-1]:
            ms[n].append(device_ms(lambda: walk(libs[n], g, q, variant=n,
                                                **kw), args.reps))
        for n in WALK_RUNS:
            print(f"walk T={t} {n}: " + " / ".join(f"{m:.3f}" for m in ms[n])
                  + " ms", flush=True)
        qv, qsc = idx._ensure_quantized()
        i8 = dict(kw, qvectors=qv, qscale=qsc)
        want = walk(libs["kernel"], g, q, **i8)
        for n in INT8_RUNS:
            got = walk(libs[n], g, q, variant=n, **i8)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"walk T={t} int8 rows {n}: ids, distances, hops and "
                  f"evals equal to the kernel's: {same}")
        ms = {n: [] for n in INT8_RUNS}
        for n in INT8_RUNS + INT8_RUNS[::-1]:
            ms[n].append(device_ms(lambda: walk(libs[n], g, q, variant=n,
                                                **i8), args.reps))
        for n in INT8_RUNS:
            print(f"walk T={t} int8 rows {n}: "
                  + " / ".join(f"{m:.3f}" for m in ms[n]) + " ms",
                  flush=True)
        r = walk_phases(libs["profile"], g, q, **kw)
        print(f"walk T={t} profile cycles a block-step "
              f"({r['steps']:.2f} steps a block): "
              f"{format_cycles(r['cycles'])}", flush=True)
    for c, sargs in sorted(sets.items()):
        *tensors, nn = sargs
        ms = device_ms(lambda: prune(libs["kernel"], tensors, nn), args.reps)
        print(f"prune B={tensors[0].shape[0]} C={c} nn={nn}: {ms:.4f} ms",
              flush=True)
        r = prune_phases(libs["profile"], tensors, nn)
        print(f"prune C={c} profile cycles ({r['pruned']} of {r['sets']} "
              f"sets pruned, {r['rounds']:.2f} rounds a pruned set; init, "
              f"write a set; search, reject a round): "
              f"{format_cycles(r['cycles'])}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
