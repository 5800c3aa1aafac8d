// The whole ef-bounded beam walk of a query batch in one launch, for NVIDIA
// Hopper (sm_90a): one thread block per query runs every step of its walk
// with its queues in shared memory, so a batch costs one launch and no
// host round trip per step.
//
// Replaces: pg_embedding_tpu/core/search.py::_search_one (:80), the
// jax.lax.while_loop (:327) that search_graph (:455), search_graph_quantized
// (:369), search_graph_packed (:392) and search_graph_pq (:418) vmap over a
// batch and XLA compiles into one device program: every traversal variant
// of it runs here.  Its plain twin is the port's torch-op walk,
// core/search._search_batch, and the kernel computes, per query, exactly
// what one lane of that walk computes:
//   * entry node 0 at the caller's entry distance (the twin's own torch op
//     on the original query and corpus row, so both walks start from the
//     same bits); no node: the padding;
//   * loop while cand_d[0] < inf && !(cand_d[0] > res_d[ef-1]) (and, with
//     the hash visited set, hops < its slots);
//   * pop the first T candidates; popped j expands iff
//     !(pop_d[j] > lower) && pop_i[j] >= 0, lower = res_d[ef-1] at the
//     step's start; slot s of the T*maxM expansion is valid iff
//     s % maxM < link_counts[pop], the link is >= 0 and its pop expands;
//   * a valid slot is processed iff no earlier valid slot holds its id and
//     its id is unvisited, by one of three visited sets:
//       dense (the default): not held by the candidate queue after the
//         pop, the result queue or the T popped ids;
//       bitmap: its bit is clear in the query's bit set over the ids
//         (zeroed, node 0's bit set); the processed ids set theirs after
//         every slot has read;
//       hash: no slot of its 4-slot bucket of the query's table (-1
//         empty, node 0 in slot 0) holds it; bucket and slot are the
//         twin's uint32 hashes; after every slot has read, each processed
//         id writes its slot, the highest expansion slot winning where two
//         choose one (the twin's index_put on the CPU);
//       either set lives in the block's shared memory where a table
//       instance has room for it (the block fills it) and an SM keeps its
//       blocks, else in device memory (the wrapper fills it: vis_place);
//   * dist_evals += processed slots; admit d < lower; results keep the ef
//     and candidates the cand_cap smallest of incumbents + admitted, ties
//     to the incumbents, then to the lower slot (merge_min_k after the
//     twin's stable pre-reduce);
//   * distances are ops/distance.dist_one_to_many's in float32: L2
//     sqrtf(sum (p - q)^2), cosine 1 - dot * rsqrtf(max(|q|^2 |p|^2,
//     1e-30)), Manhattan sum |p - q|; products and sums are rounded one by
//     one (no contraction into FMA), as the twin's separate torch ops are.
//     The query is the walk's (under OPQ, q @ R: the wrapper passes it).
// Neighbour rows (phase 3's source, a template parameter) are the twin's
// float32 values of:
//   * float32 corpus rows [cap, D] (read at the id) or packed records
//     [cap, maxM, D] (record p, slot r holds the row of links[p, r]; read
//     at the popped row's slot): the same values, so the same walk;
//   * int8 rows [cap, D] x a scale f32[cap], or int8 records x f32[cap,
//     maxM]: code * scale, one rounding (__fmul_rn);
//   * bf16 corpus rows or records, widened exactly; with cosine over bf16
//     corpus rows, |p|^2 is rounded to bf16 and back, as the twin's
//     _sum_sq of a bf16 operand does (records are widened first: no);
//   * int8 and bf16 records and rows are staged where the launch asks for
//     it: phase 1 copies each popped row's whole record (and its scales),
//     or phase 2 each processed slot's row (and its scale), to shared
//     memory, and phase 3 reads slot s's row there (kElemI8Staged,
//     kElemBF16Staged), the same values in the same order, so the same
//     walk;
//   * float32 records keep a ring of K rows where the launch asks for it:
//     phase 2 copies the rows of the first K processed slots, in the order
//     the dedupe compacts them (kElemF32Staged), and phase 3 reads the
//     entries past K from the records, then entry e < K's row in the ring:
//     the same values, so the same walk;
//   * PQ records u8[cap, maxM, G] through the codebook f32[G, 256, D / G]:
//     element c is codebook[c / sub, code[c / sub], c % sub] (ops/pq
//     pq_decode).  The row is never decoded: the metric's sum splits by
//     group, so each block first builds its query's distance table in
//     shared memory (device memory where it does not fit: pq_place; entry
//     (k, g) at k G + g, the group minor: L2 sum (c - q)^2, Manhattan sum
//     |c - q|, cosine (sum c q, sum c^2) as a float2,
//     each summed as accum sums a row, from 0 in element order), and a
//     row's lane partial is the sum of its groups' entries, lane g holding
//     groups g, g + 32, ...  At D / G = 4 that is the partial the decoded
//     row's lane c = g would sum, bit for bit (ops/cuda_graph
//     pq_walk_table_plain and pq_walk_score_plain are its plain form).
// The exact rerank of approximate sources and the hash mode's duplicate
// drop stay torch ops after the walk (core/search.finish_walk), on both
// routes.
//
// What bounds it on an H100: the bytes it must read,
//   sum_q (dist_evals_q * row_bytes + hops_q * T * (maxM + 1) * 4)
//   + B * D * 4,
// row_bytes = 4 D for float32 rows, 2 D for bf16, D + 4 for int8 and its
// scale, G for PQ codes (plus, for the bitmap and hash sets in device
// memory, the words each processed id reads and writes, and the sets'
// initialisation; the
// PQ codebook, 1 KB a group, is read from device memory once a launch and
// from L2 by each block's table build);
// about 0.36 ms at 3.35 TB/s for 1,024 queries at 1M x 128-d float32
// rows (ef = 64, T = 8, ~2,240 processed neighbours a query).  A walk is a
// chain of dependent steps (mean 17 at T = 8, up to 38), so the design
// keeps each step's chain short and enough queries resident to overlap
// their latencies.
//
// Design.  A step has five phases, each ended by one block barrier (the
// earlier design's step had six, and serial loops in three of them):
//   1. links: a thread a slot loads the popped row's count and link
//      together (in flight while the thread inserts the queues' ids; PQ
//      records: and copies the slot's code bytes to shared memory, whose
//      place is known before the link arrives: stage_pq_codes; staged
//      int8 / bf16 records: thread j has the copy engine copy popped row
//      j's whole record to shared memory, stage_records), and
//      inserts each valid slot's id into a shared hash table keyed by id
//      whose value is the smallest slot holding it (atomicMin); the ids of
//      both queues, the popped ones included, go into a second table (the
//      "held" set).  Both tables are open-addressed with linear probing,
//      sized to a power of two of at least twice their keys.  Under the
//      bitmap or hash set the held table stays empty, and each slot's set
//      words (vis_word: the bitmap's word, or the hash bucket's 16 bytes)
//      are read as its link lands, before its insert, into registers;
//   2. dedupe: each slot probes both tables once: it is processed iff its
//      id is not held and it is its id's smallest slot.  That is the dense
//      dedupe's answer, so dist_evals do not change.  Under a set the slot
//      tests the words it read in phase 1 instead (a uniform branch; the
//      set changes only in phase 3, and two block barriers stand between
//      one step's writes and the next step's reads).  Processed slots are
//      compacted with one shared atomic a warp (staged int8 / bf16 rows:
//      the copy engine copies each processed slot's row to shared
//      memory as the dedupe keeps it, stage_row; float32 records in a
//      ring: each of the first K processed slots' record row to its
//      compacted entry, stage_ring_row);
//   3. rows: each warp scores kRowsPerWarp = 8 neighbours at a time, their
//      row loads issued together; the metric is a template parameter (no
//      branch per element) and the 8 sums go through one butterfly that
//      also halves the rows each lane carries (9 shuffles, not 40; the
//      same additions, so the same bits), leaving each lane group one
//      row's distance; the admitted (d < lower) are appended with one
//      atomic a warp; the tables are cleared for the next step.  First the
//      bitmap's processed ids set their bits (atomicOr), or the last warp
//      writes the hash table's slots in 32-slot chunks in slot order, a
//      match
//      among the chunk's lanes leaving the highest slot of each table slot
//      to write it;
//   4. rank: the admitted are ranked by (d, slot): g lanes an entry (a
//      power of two up to 32, as many as the block can spare), each
//      counting a g-th of the entries below it, then a shuffle sum;
//   5. merge: each queue by rank (an incumbent moves down by the admitted
//      strictly below it, an admitted entry by the incumbents at or below
//      it: binary searches), into its second buffer.
// Each row source and visited-set kind (the dense dedupe, or a set) is one
// instance: 8 x 2 (PQ twice: kElemPQ, kElemPQFar;
// int8 and bf16 staged records or rows beside them; float32 records in a
// ring beside float32 rows and records), by 128 or 256
// threads: thirty-two (the dense instances compile the sets' branches
// away; graph_probe's sets-runtime variant keeps them); the records /
// rows choice and bitmap / hash are uniform runtime branches, and a set in
// shared or device memory is the same code through a pointer.
// 128 threads a block where T * maxM <= 128 (T <= 4 at maxM = 32), else 256; an SM holds 5 blocks of 128 (96
// registers a thread) or 4 of 256 (64): shapes chosen by measurement
// (PERF.md; graph_probe.py).  Where the tables do not fit beside the
// queues (very wide D or T) the dedupe compares each slot with the queues
// and earlier slots instead (the same answer).
//
// The wide instances (ef or cand_cap above kMaxQueue = 320: the API's
// widening from ef_search 40 passes it at 640 and reaches up to 8,191 on
// its last doubling, and a caller may pass up to 2^20): rebuilding a held
// table of 2 (ef + cand_cap) slots every step, to test the step's T * maxM
// slots against it, costs more than the rest of the step from ~512
// entries a queue (graph_probe --mode wide's crossover, PERF.md), so
// beam_walk_wide_kernel keeps the membership from step to step instead.
// Per query, two bits an id in device memory ("held": in the result
// queue, in the candidate queue; (rows + 15) / 16 words a query, zeroed
// by the wrapper before each launch, node 0's set at the start): each
// slot reads its id's word (issued as its link arrives, so the read
// overlaps the slot table's inserts) and the step updates the bits after
// every slot has read them: the popped ids leave the candidate queue
// (phase 3), the incumbents pushed past ef or cand_cap clear theirs as the
// merge moves them, the admitted that land set theirs (the held lap).
// The membership changes only that way, so the dense rule's answer, and
// dist_evals, are the same.  The queues are one buffer each, in shared
// memory where they fit (up to ef = cand_cap = 8,191 at D = 128), else in
// device memory after the held bits, the same code through a pointer:
//   * the candidate queue is a ring of cand_cap rounded up to a multiple
//     of T: the pop advances its head by T (the popped T entries are
//     always contiguous), and the places of the next pop past the queue's
//     length are emptied after the merge;
//   * the merge is in place: the admitted's places come first (a binary
//     search of each queue), then the incumbents they displace, a suffix,
//     move down tail first in rounds of kMoveRun entries a thread (each
//     round reads, meets a barrier, writes: an incumbent only moves down,
//     so a round never overwrites what a later round reads), then the
//     admitted land; an incumbent pushed past the queue's width clears
//     its held bit instead.
// Seven wide instances, a row source each, 256 threads, the visited set a
// runtime branch (the bitmap and hash sets keep no held bits, and stay in
// device memory: at ef 5,120 the API's hash set is 2^20 slots; their
// words are read in phase 1 as the held word is), two blocks
// an SM (128 registers).  Python computes the shared-memory figure and
// the device memory a query (ops/cuda_graph._walk_layout,
// _walk_wide_words) and the launch refuses other ones, or shared memory
// above 232,448 bytes.
//
// What holds it back now: each step still waits on two dependent global
// latencies (the links, then the rows) plus one for each further round of
// 8 rows a warp, and the block's five barriers make every phase wait for
// its slowest warp; at 64 registers (T = 8) the kernel spills (ptxas).  A
// PQ step waits on the links alone: its codes are copied to shared memory
// beside them (phase 1), and its rows lap is shared reads (~5,900 cycles a
// step at G = 32 against ~28,800 when each round loaded its codes, then
// the centroids); its table's build at the walk's start, every resident
// block at once, is bound by L2's bandwidth (~8% of a block's cycles at G
// = 32), and the table costs residency: 1 KB a group (2 KB under cosine)
// beside the queues, so G = 32 under cosine or G = 64 leave 2 blocks an
// SM.  Where the table and the codes do not both fit a block (wide rows:
// cosine at G = 96 on 1536-d), each row's codes are read from the records
// in phase 3 (a dependent latency again); where the table alone does not
// (cosine past G ~ 100, L2 past ~ 200), it is built in the query's
// device scratch and read through L1 and L2 (pq_place).  Records read
// from device memory wait on the rows' load after the links' in every
// round (int8 records 0.853 ms at T = 8 against int8 rows' 0.706: the
// rows lap ~16,600 cycles a step against ~12,700 for float32 rows).  A
// staged int8 / bf16 records step waits on the links alone: the copy
// engine brings each popped row's record while phase 1 inserts the ids,
// and the rows lap is shared reads (int8 T = 8: ~8,400 cycles a step,
// 0.654 ms; the links lap grows ~4,300 -> ~6,300 cycles with the copies'
// issue).  The staged records cost residency, T maxM D elements a block
// (64 KB for bf16 at T = 8: 2 blocks an SM, slower than reading the
// records at 4), so the launch stages only where an SM keeps its blocks
// (ops/cuda_graph._records_place).  16-byte cp.async copies spread over
// the block instead of one bulk copy a record: 0.761 against 0.654 ms
// (graph_probe --mode records; PERF.md).  Staged int8 / bf16 rows wait
// on no row load in phase 3 either, but a row's place is its link, so its
// copy waits on the link and lands within the step: the rows lap falls
// (int8 T = 8: ~11,200 -> ~8,600 cycles a step) and the wait moves into
// phase 2 (dedupe ~4,100 -> ~6,200; issued in phase 1 instead, links
// ~4,300 -> ~6,000), so the walk gains 2-4% (graph_probe --mode rows).
// Read from shared memory or device memory, a step at T = 8 is now bound
// by issue: four resident blocks of 8 warps share an SM's schedulers, and
// the rows lap's widening and sums (every operation rounded on its own)
// take ~8,500 cycles a step for staged rows and records alike.
// A wide step adds the held word's read to the links' latency, and its
// in-place merge shifts both queues' suffixes every step, a barrier a
// round: at ef = cand_cap = 5120 the move is ~46% of a step (PERF.md).
// The bitmap and hash sets' words, read in phase 2 after the links'
// barrier, were a third dependent latency a step (dedupe ~5,900-6,400
// cycles at T = 8); read as each link lands they are ~3,300-4,200, and a
// set in device memory costs the walk 0-5% over the same set shared
// (graph_probe --mode sets).  The hash set's ordered writes sat behind
// warp 0's share of the rows (rows lap ~14,200 cycles at T = 8); by the
// last warp, each chunk read a chunk ahead, ~10,900.
// Float32 records read from device memory wait on their rows as int8
// records did: each record row is read once, from HBM, 8 rows a warp a
// round (rows lap ~12,900 cycles a step at T = 4 against ~8,200 for float32
// rows).  Staged whole, as int8 records are, they would take 128 KB a
// block at T = 8, so a ring holds the processed slots' rows alone, K of
// them, K the most that keep an SM's blocks (71 at T = 4 at config 1's
// shapes: ops/cuda_graph._records_place): the rows lap falls to ~7,500,
// dedupe grows ~3,700 -> ~5,900 as it starts the copies, and the walk
// gains 15% (graph_probe --mode records).  The 256-thread instances (T
// maxM > 128) spill ~170 B a thread at 64 registers, and their blocks'
// stacks live in the L1 that the ring's shared bytes take: there the
// ring lost at every K tried (0.91-1.10 ms against 0.90 at T = 8, at 128
// threads and at 3 blocks an SM too), so the placement rule keeps it to
// the 128-thread blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRowsPerWarp = 8;          // rows a warp scores at once
static_assert(kRowsPerWarp >= 1 && kRowsPerWarp <= 32 &&
                  (kRowsPerWarp & (kRowsPerWarp - 1)) == 0,
              "rows a warp: a power of two up to 32");
// blocks an SM must hold at once, which caps the registers a thread: 5 x
// 128 threads (96 registers), 4 x 256 (64)
template <int kThreads>
constexpr int kMinBlocks = kThreads == 128 ? 5 : 4;
constexpr int kSmemLimit = 232448;
// ef and cand_cap up to kMaxQueue: the instances that rebuild a held
// table each step; wider (the API's widening from ef_search 40 passes it
// at 640, and reaches up to 8,191), up to kMaxWideQueue: the wide
// instances (the crossover measured by graph_probe --mode wide)
constexpr int kMaxQueue = 320;
constexpr int kMaxWideQueue = 1 << 20;
// the wide instances: a block's threads, the blocks an SM must hold (128
// registers a thread), the incumbents each thread moves a merge round
constexpr int kWideThreads = 256;
constexpr int kWideMinBlocks = 2;
constexpr int kMoveRun = 4;
// an id's two held bits (bits 2 (id % 16) and up of word id / 16)
constexpr unsigned kInRes = 1u;
constexpr unsigned kInCand = 2u;
constexpr int kMetricL2 = 0;
constexpr int kMetricCosine = 1;
constexpr int kMetricManhattan = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = -1;
// phase 3's row sources (the element type of the rows or records)
constexpr int kElemF32 = 0;              // float32
constexpr int kElemI8 = 1;               // int8 x a float32 scale a row
constexpr int kElemBF16 = 2;             // bfloat16
constexpr int kElemPQ = 3;               // uint8 PQ codes x the codebook
// PQ codes whose table and step's codes do not both fit a block
// (pq_place): each row's codes read from the records, the table in shared
// or device memory.  An instance of its own, so that kElemPQ's lookups
// stay shared loads with no runtime choice of memory in their way.
constexpr int kElemPQFar = 4;
// int8 and bf16 records whose popped rows' records phase 1 copies whole to
// shared memory (records_place): instances of their own, so that their
// reads are shared loads with no runtime choice of memory in their way;
// kElemI8 / kElemBF16 read the records where they are not staged.
constexpr int kElemI8Staged = 5;
constexpr int kElemBF16Staged = 6;
// float32 records whose processed slots' rows phase 2 copies to a ring of
// K rows in shared memory (records_place's ring), the rest read from the
// records: an instance of its own (table instances only), so that kElemF32
// keeps its code
constexpr int kElemF32Staged = 7;
__host__ __device__ constexpr bool is_pq(int elem) {
  return elem == kElemPQ || elem == kElemPQFar;
}
__host__ __device__ constexpr bool is_staged(int elem) {
  return elem == kElemI8Staged || elem == kElemBF16Staged;
}
__host__ __device__ constexpr bool is_ring(int elem) {
  return elem == kElemF32Staged;
}
// the element type an instance's rows hold
__host__ __device__ constexpr int elem_type(int elem) {
  return elem == kElemI8Staged     ? kElemI8
         : elem == kElemBF16Staged ? kElemBF16
         : elem == kElemF32Staged  ? kElemF32
                                   : elem;
}
// the visited sets (the API's visited_slots: -1, 0, 2^s)
constexpr int kVisDense = 0;
constexpr int kVisBitmap = 1;
constexpr int kVisHash = 2;
// the hash set's uint32 hashes (core/search._hash_buckets, _hash_slot_choice)
constexpr unsigned kBucketHash = 2654435761u;
constexpr unsigned kSlotHash = 0x9E3779B1u;

// Phase clocks of the instrumented build (-DPG_PROFILE): thread 0 of each
// block sums its laps (each phase ends at a block barrier, so a lap is the
// block's time in it) and adds them to g_walk_prof at the end.
// (the wide instances: merge is the admitted's places, then move and held)
enum { kLapSetup, kLapLinks, kLapDedupe, kLapRows, kLapRank, kLapMerge,
       kLapMove, kLapHeld, kLaps };
#ifdef PG_PROFILE
// the laps' cycles, then steps, blocks
__device__ unsigned long long g_walk_prof[kLaps + 2];
struct Laps {
  long long t, acc[kLaps];
  __device__ void start() {
    t = clock64();
    for (int i = 0; i < kLaps; ++i) acc[i] = 0;
  }
  __device__ void lap(int i) {
    const long long now = clock64();
    acc[i] += now - t;
    t = now;
  }
  __device__ void flush(int steps) {
    for (int i = 0; i < kLaps; ++i)
      atomicAdd(&g_walk_prof[i], (unsigned long long)acc[i]);
    atomicAdd(&g_walk_prof[kLaps], (unsigned long long)steps);
    atomicAdd(&g_walk_prof[kLaps + 1], 1ull);
  }
  // a barrier of the instrumented build alone, where a lap needs one
  __device__ void barrier() { __syncthreads(); }
};
#else
struct Laps {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void flush(int) {}
  __device__ void barrier() {}
};
#endif

size_t pow2_at_least(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Where a PQ source keeps its distance table and its step's codes, given
// ``used``, the shared bytes of the block's least layout (the room is what
// is left of kSmemLimit):
// the table (256 codes x G groups, a float each, a float2 under cosine:
// the dot product and the centroid's sum of squares) and the staged codes
// (T maxM slots x G bytes, rounded up to 8) in shared memory where both
// fit; else the table alone, each row's codes read from the records; else
// the table in device memory, ``words`` int32 a query after every query's
// own scratch (8-aligned), the codes from the records.  All 0 for the
// other sources (groups = 0).
struct PqPlace {
  size_t smem;     // shared bytes: the table where shared, staged codes
  size_t words;    // device words a query: the table where not shared
  int staged;      // the step's codes copied to shared memory after it
};

__host__ __device__ __forceinline__ size_t pq_table_bytes(int groups,
                                                          int metric) {
  return (size_t)256 * groups * (metric == kMetricCosine ? 8 : 4);
}

__host__ __device__ __forceinline__ size_t pq_code_bytes(int groups, int T,
                                                         int maxM) {
  return ((size_t)T * maxM * groups + 7) / 8 * 8;
}

PqPlace pq_place(int groups, int metric, int T, int maxM, size_t used) {
  if (groups <= 0) return {0, 0, 0};
  const size_t room = used < (size_t)kSmemLimit ? kSmemLimit - used : 0;
  const size_t table = pq_table_bytes(groups, metric);
  const size_t codes = pq_code_bytes(groups, T, maxM);
  if (table + codes <= room) return {table + codes, 0, 1};
  if (table <= room) return {table, 0, 0};
  return {0, table / 4, 0};
}

// Where an int8 or bf16 records or rows source can keep each step's rows
// (kElemI8Staged / kElemBF16Staged): the T popped rows' whole records, or
// the T maxM slots' rows (T maxM D elements of ``elem_bytes`` either
// way), then an int8 source's T maxM scales, each rounded up to 16 bytes,
// in shared memory at offset ``at`` (the block's region, after every
// other part), where
//   * the bulk copy's 16-byte alignment holds: the bytes of what one copy
//     moves (a record, or with ``rows`` a row), an int8 record's scales,
//     the region and the tensors' bases (``aligned``: a rows source's
//     scales are copied 4 bytes at a time);
//   * they fit beside the ``used`` bytes of the rest of the layout.
// Else none (0 bytes): each slot read from the records or rows in phase
// 3.  Nothing else of the layout moves.  Whether a walk that can stage
// does is the caller's choice (ops/cuda_graph._records_place holds the
// rule: an SM keeps its blocks), told by the shared bytes it passes
// (beam_walk).  Float32 records keep a ring of ``ring`` rows of D floats
// instead (kElemF32Staged: the first ``ring`` processed slots' rows a
// step), where a row is whole 16-byte chunks and the base and region are
// 16-aligned; its rows are the caller's figure, read from the shared
// bytes it passes.
struct RecPlace {
  size_t smem;     // shared bytes: the staged records or rows and scales
  int staged;
  int ring;        // float32 records: the ring's rows (0: none)
};

int walk_threads(int T, int maxM) {
  return T * maxM <= 128 ? 128 : 256;
}

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ size_t rec_rows_bytes(int elem_bytes,
                                                          int T, int maxM,
                                                          int D) {
  return round16((size_t)T * maxM * D * elem_bytes);
}

// The staged records' or rows' bytes and, with ``scales``, their int8
// scales'.
__host__ __device__ __forceinline__ size_t rec_stage_bytes(int elem_bytes,
                                                           bool scales, int T,
                                                           int maxM, int D) {
  return rec_rows_bytes(elem_bytes, T, maxM, D) +
         (scales ? round16((size_t)T * maxM * 4) : 0);
}

RecPlace records_place(int elem_bytes, int scales, int rows, int aligned,
                       int T, int maxM, int D, size_t at, size_t used,
                       int ring = 0) {
  if (elem_bytes <= 0 || !aligned) return {0, 0, 0};
  // what one bulk copy moves: a slot's row (a rows source's, a ring's), or
  // a popped row's record
  const size_t unit = (size_t)(rows || ring ? 1 : maxM) * D * elem_bytes;
  if (unit % 16 || (scales && !rows && maxM * 4 % 16) || at % 16)
    return {0, 0, 0};
  const size_t bytes = ring ? (size_t)ring * unit
                            : rec_stage_bytes(elem_bytes, scales, T, maxM, D);
  if (used + bytes > (size_t)kSmemLimit) return {0, 0, 0};
  return {bytes, 1, ring};
}

// Where a table instance can keep the query's bitmap or hash visited set
// of ``words`` int32 (the bitmap's ceil(rows / 32), the hash table's
// slots; 0: no set): in shared memory after every other part of the
// layout (``used`` bytes), from the next 16-byte boundary (a hash bucket
// is one 16-byte load), where it fits within kSmemLimit; else none (0
// bytes): the set stays in device memory.  Nothing else of the layout
// moves.  Whether a walk that can keep it there does is the caller's
// choice (ops/cuda_graph._visited_place holds the rule: an SM keeps its
// blocks), told by the shared bytes it passes and a null ``visited``
// (beam_walk).
struct VisPlace {
  size_t smem;     // shared bytes: the padding to 16, then the set
  int shared;
};

VisPlace vis_place(size_t words, size_t used) {
  if (words == 0) return {0, 0};
  const size_t at = round16(used);
  const size_t bytes = at - used + round16(4 * words);
  if (used + bytes > (size_t)kSmemLimit) return {0, 0};
  return {bytes, 1};
}

// Shared memory: the query row (D rounded up to 4 floats), the result and
// candidate queues twice (d, id), per expansion slot its id, the compacted
// processed slots, the admitted (d, slot) and their ranked (d, id), 8
// counters, then the held table (held_n ids) and the slot table (slot_n
// ids and slot_n smallest slots), then a PQ source's table and staged
// codes (pq_place, placed first: the tables take what it leaves, and are
// left out (0) where they do not fit) or an int8 / bf16 records or rows
// source's staged rows, or a float32 records ring of ``rec_ring`` rows
// (records_place, placed after the rest: nothing else moves), then a
// bitmap or hash visited set of ``vis_words`` where it is asked for and
// fits (vis_place, placed last).
// The wide instances (ef or cap above kMaxQueue): the query row, the slot
// arrays, the counters, the slot table, the PQ table and codes or the
// staged rows, then each queue once (d, id; the candidate ring of
// ``ring`` entries) where they fit; device memory,
// ``words`` int32 a query: the held bits (``held_words``, two bits an id
// of ``rows``: the dense dedupe only), then the queues where they do not
// fit in shared memory; a PQ table that does not fit there takes pq.words
// more, laid out after every query's own words (a table a query:
// RowSource::pq_tables).  Their visited sets stay in device memory.
struct WalkLayout {
  size_t smem;
  int held_n, slot_n, ring;
  size_t held_words, words;
  int queues_shared;
  PqPlace pq;
  RecPlace rec;
  VisPlace vis;
};

// The device words a query: ``words`` of the walk's own, then the PQ
// table's (the own words rounded up to 2 first, so that the tables, after
// all the queries' own words, are 8-aligned).
size_t with_pq_words(size_t words, const PqPlace& pq) {
  return pq.words ? (words + 1) / 2 * 2 + pq.words : words;
}

WalkLayout walk_layout(int ef, int cap, int T, int maxM, int D, int rows,
                       bool dense, int groups, int metric, int rec_elem,
                       int rec_scales, int rec_rows, int rec_aligned,
                       size_t vis_words, int rec_ring = 0) {
  const size_t tm = (size_t)T * maxM;
  const size_t row = 4 * (size_t)((D + 3) / 4 * 4);
  const size_t slots = pow2_at_least(2 * tm);
  if (ef > kMaxQueue || cap > kMaxQueue) {
    // the wide instances keep no ring: float32 records read the records
    if (rec_ring) rec_elem = 0;
    const size_t ring = ((size_t)cap + T - 1) / T * T;
    size_t fixed = row + 24 * tm + 32 + 8 * slots;
    const PqPlace pq = pq_place(groups, metric, T, maxM, fixed);
    fixed += pq.smem;
    const size_t queues = 8 * ((size_t)ef + ring);
    const size_t held = dense ? ((size_t)rows + 15) / 16 : 0;
    if (fixed + queues <= (size_t)kSmemLimit) {
      const RecPlace rec =
          records_place(rec_elem, rec_scales, rec_rows, rec_aligned, T, maxM,
                        D, fixed, fixed + queues);
      return {fixed + rec.smem + queues, 0, (int)slots, (int)ring, held,
              with_pq_words(held, pq), 1, pq, rec, {0, 0}};
    }
    const RecPlace rec = records_place(rec_elem, rec_scales, rec_rows,
                                       rec_aligned, T, maxM, D, fixed, fixed);
    return {fixed + rec.smem, 0, (int)slots, (int)ring, held,
            with_pq_words(held + queues / 4, pq), 0, pq, rec, {0, 0}};
  }
  const size_t held = pow2_at_least(2 * ((size_t)ef + cap));
  size_t base = row + 16 * ((size_t)ef + cap) + 24 * tm + 32;
  const PqPlace pq = pq_place(groups, metric, T, maxM, base);
  base += pq.smem;
  const size_t tables = 4 * held + 8 * slots;
  if (base + tables <= (size_t)kSmemLimit) {
    const size_t used = base + tables;
    const RecPlace rec = records_place(rec_elem, rec_scales, rec_rows,
                                       rec_aligned, T, maxM, D, used, used,
                                       rec_ring);
    const VisPlace vis = vis_place(vis_words, used + rec.smem);
    return {used + rec.smem + vis.smem, (int)held, (int)slots, 0, 0,
            pq.words, 1, pq, rec, vis};
  }
  const RecPlace rec = records_place(rec_elem, rec_scales, rec_rows,
                                     rec_aligned, T, maxM, D, base, base,
                                     rec_ring);
  const VisPlace vis = vis_place(vis_words, base + rec.smem);
  return {base + rec.smem + vis.smem, 0, 0, 0, 0, pq.words, 1, pq, rec,
          vis};
}

__device__ __forceinline__ unsigned hash_id(int id, int n) {
  unsigned h = (unsigned)id * 0x9E3779B1u;
  return (h ^ (h >> 15)) & (unsigned)(n - 1);
}

__device__ __forceinline__ void held_insert(int* tab, int n, int id) {
  for (unsigned h = hash_id(id, n);; h = (h + 1) & (unsigned)(n - 1)) {
    const int old = atomicCAS(tab + h, kEmpty, id);
    if (old == kEmpty || old == id) return;
  }
}

__device__ __forceinline__ bool held_has(const int* tab, int n, int id) {
  for (unsigned h = hash_id(id, n);; h = (h + 1) & (unsigned)(n - 1)) {
    const int k = tab[h];
    if (k == id) return true;
    if (k == kEmpty) return false;
  }
}

// Records slot s as holding id: the table keeps the smallest such slot.
__device__ __forceinline__ void slot_insert(int* keys, int* first, int n,
                                            int id, int s) {
  for (unsigned h = hash_id(id, n);; h = (h + 1) & (unsigned)(n - 1)) {
    const int old = atomicCAS(keys + h, kEmpty, id);
    if (old == kEmpty || old == id) {
      atomicMin(first + h, s);
      return;
    }
  }
}

// The smallest slot holding id (which was inserted).
__device__ __forceinline__ int slot_first(const int* keys, const int* first,
                                          int n, int id) {
  unsigned h = hash_id(id, n);
  while (keys[h] != id) h = (h + 1) & (unsigned)(n - 1);
  return first[h];
}

// The hash set's table slot that ``id`` reads first (its 4-slot bucket
// starts there) and the one it writes.
__device__ __forceinline__ int vis_bucket(int id, int slots) {
  return (int)(((unsigned)id * kBucketHash) & ((unsigned)(slots - 1) & ~3u));
}

__device__ __forceinline__ int vis_slot(int id, int slots) {
  return vis_bucket(id, slots) + (int)(((unsigned)id * kSlotHash) >> 30);
}

// The words of the query's visited set (bitmap words or hash table, in
// shared or device memory) that say whether it holds id: the bitmap's word
// id / 32 (in .x), or the hash set's 4-slot bucket, one 16-byte load (a
// bucket starts at a multiple of 4 slots, and a query's table at a
// multiple of 16 bytes).
__device__ __forceinline__ int4 vis_word(const int* vis, int mode, int n,
                                         int id) {
  if (mode == kVisBitmap) return make_int4(vis[id >> 5], 0, 0, 0);
  return *reinterpret_cast<const int4*>(vis + vis_bucket(id, n));
}

// Whether those words hold id.
__device__ __forceinline__ bool vis_holds(int4 w, int mode, int id) {
  if (mode == kVisBitmap) return ((unsigned)w.x >> (id & 31)) & 1u;
  return w.x == id || w.y == id || w.z == id || w.w == id;
}

// Where phase 3 reads a neighbour's row: the rows or records of one element
// type, each element widened to the float32 value the twin computes.
// PQ records leave the int8 scales unused and take their tables' place in
// that field (pq_place), and a float32 records ring's rows take the PQ
// groups' (records_place): the layout, and so the kernels' parameters, are
// those of every other source.
struct RowSource {
  const void* rows;       // [cap, D] rows or [cap, maxM, D] records (PQ: G)
  union {
    const float* scales;  // int8: f32[cap] or f32[cap, maxM]
    float* pq_tables;     // PQ: the queries' tables in device memory, a
                          // table a query, or null: in shared memory
  };
  const float* codebook;  // PQ: f32[G, 256, sub]
  union {
    int groups;           // PQ: G
    int ring;             // float32 records in a ring (kElemF32Staged): K
  };
  int sub;                // PQ: D / G
  int records;            // read at the popped row's slot, not at the id
  int round_pp;           // bf16 corpus rows under cosine: |p|^2 to bf16
  int vec;                // 4-element loads (alignment and D allow them;
                          // PQ: of the codebook, in the table's build)
};

// A staged records or rows source's region (records_place): popped row
// j's record at rows + j maxM D elements, so slot s's row at rows + s D
// (a rows source copies slot s's row there); an int8 source's scales
// after them, slot s's at scales[s]; a float32 ring's processed entry e <
// K at rows + e D; the step's bulk copies complete on ``bar``.  All null
// for the other sources.
struct RecStage {
  unsigned char* rows;
  float* scales;
  unsigned long long* bar;
};

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Byte k of w as a signed code, times the row's scale: one rounding.
__device__ __forceinline__ float i8_at(int w, int k, float sc) {
  return __fmul_rn((float)((int)((unsigned)w << (24 - 8 * k)) >> 24), sc);
}

// The raw bits of 4 elements (the vector path: a float4, 4 int8 in 32
// bits, 4 bf16 in 64 bits) and of one (the scalar path).  A warp's rows
// are loaded raw, all in flight together, and widened only after: a
// widening right behind its load would wait on it before the next row's
// load is issued (graph_probe's widen-at-load variant).  PQ rows are not
// loaded this way: their codes index the query's table (score_rows).
template <int kElem>
struct Raw {
  using Vec = float4;
  using One = float;
};
template <>
struct Raw<kElemI8> {
  using Vec = int;
  using One = int;
};
template <>
struct Raw<kElemBF16> {
  using Vec = uint2;
  using One = unsigned;
};

template <>
struct Raw<kElemI8Staged> : Raw<kElemI8> {};
template <>
struct Raw<kElemBF16Staged> : Raw<kElemBF16> {};

// Elements [4c, 4c + 4) of row ``at``, raw (staged: slot ``at``'s row in
// shared memory; a ring: ring row ``at``).
template <int kElem>
__device__ __forceinline__ typename Raw<kElem>::Vec load4(
    const RowSource& src, const RecStage& rs, size_t at, int c, int D) {
  static_assert(!is_pq(kElem), "PQ rows are read through the table");
  if constexpr (kElem == kElemF32Staged) {
    return reinterpret_cast<const float4*>(rs.rows)[(int)at * (D / 4) + c];
  } else if constexpr (kElem == kElemI8Staged) {
    return reinterpret_cast<const int*>(rs.rows)[(int)at * (D / 4) + c];
  } else if constexpr (kElem == kElemBF16Staged) {
    return reinterpret_cast<const uint2*>(rs.rows)[(int)at * (D / 4) + c];
  } else if constexpr (kElem == kElemF32) {
    return __ldg(reinterpret_cast<const float4*>(src.rows) + at * (D / 4) +
                 c);
  } else if constexpr (kElem == kElemI8) {
    return __ldg(reinterpret_cast<const int*>(src.rows) + at * (D / 4) + c);
  } else {
    return __ldg(reinterpret_cast<const uint2*>(src.rows) + at * (D / 4) +
                 c);
  }
}

// Element e of row ``at`` (the scalar path, any D), raw.
template <int kElem>
__device__ __forceinline__ typename Raw<kElem>::One load1(
    const RowSource& src, const RecStage& rs, size_t at, int e, int D) {
  static_assert(!is_pq(kElem), "PQ rows are read through the table");
  if constexpr (kElem == kElemF32Staged) {
    return reinterpret_cast<const float*>(rs.rows)[(int)at * D + e];
  } else if constexpr (kElem == kElemI8Staged) {
    return reinterpret_cast<const signed char*>(rs.rows)[(int)at * D + e];
  } else if constexpr (kElem == kElemBF16Staged) {
    return reinterpret_cast<const unsigned short*>(rs.rows)[(int)at * D + e];
  } else if constexpr (kElem == kElemF32) {
    return __ldg(reinterpret_cast<const float*>(src.rows) + at * D + e);
  } else if constexpr (kElem == kElemI8) {
    return __ldg(reinterpret_cast<const signed char*>(src.rows) + at * D + e);
  } else {
    return __ldg(reinterpret_cast<const unsigned short*>(src.rows) + at * D +
                 e);
  }
}

// Row ``at``'s int8 scale (staged: slot ``at``'s, in shared memory).
template <int kElem>
__device__ __forceinline__ float scale_at(const RowSource& src,
                                          const RecStage& rs, int at) {
  if constexpr (is_staged(kElem))
    return rs.scales[at];
  else
    return __ldg(src.scales + at);
}

// The float32 values of raw elements (int8: times the row's scale ``sc``).
template <int kElem>
__device__ __forceinline__ float4 widen4(typename Raw<kElem>::Vec w,
                                         float sc) {
  if constexpr (kElem == kElemI8) {
    return make_float4(i8_at(w, 0, sc), i8_at(w, 1, sc), i8_at(w, 2, sc),
                       i8_at(w, 3, sc));
  } else if constexpr (kElem == kElemBF16) {
    return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                       bf16_hi(w.y));
  } else {
    return w;
  }
}

template <int kElem>
__device__ __forceinline__ float widen1(typename Raw<kElem>::One w,
                                        float sc) {
  if constexpr (kElem == kElemI8) {
    return __fmul_rn((float)w, sc);
  } else if constexpr (kElem == kElemBF16) {
    return bf16_lo(w);
  } else {
    return w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Accumulate one element pair into the metric's sums.
template <int kMetric>
__device__ __forceinline__ void accum(float p, float q, float& a, float& pp) {
  if (kMetric == kMetricL2) {
    const float t = __fsub_rn(p, q);
    a = __fadd_rn(a, __fmul_rn(t, t));
  } else if (kMetric == kMetricCosine) {
    a = __fadd_rn(a, __fmul_rn(p, q));
    pp = __fadd_rn(pp, __fmul_rn(p, p));
  } else {
    a = __fadd_rn(a, fabsf(__fsub_rn(p, q)));
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The staged records' or rows' mbarrier: ``count`` arrivals a phase (one
// a popped row, or one a slot), each adding the bytes its copies complete
// on it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the barrier's phase of parity ``phase`` to end.  A copy that is
// only delayed is waited for; one that has not landed after 10 s of the
// global timer traps, a launch error in place of a card that never answers.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  unsigned long long start = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > 10000000000ull)
      __trap();
  }
}

template <int kElem>
__device__ __forceinline__ RecStage rec_stage(unsigned char* region,
                                              int* ctr, int T, int maxM,
                                              int D) {
  if constexpr (is_staged(kElem)) {
    constexpr int kBytes = elem_type(kElem) == kElemI8 ? 1 : 2;
    return {region,
            elem_type(kElem) == kElemI8
                ? reinterpret_cast<float*>(
                      region + rec_rows_bytes(kBytes, T, maxM, D))
                : nullptr,
            // counters 6 and 7 (8-aligned: ctr is)
            reinterpret_cast<unsigned long long*>(ctr + 6)};
  } else if constexpr (is_ring(kElem)) {
    return {region, nullptr, reinterpret_cast<unsigned long long*>(ctr + 6)};
  } else {
    return {nullptr, nullptr, nullptr};
  }
}

// Phase 1 (int8 / bf16 records, staged): each popped row's whole record,
// and an int8 record's scales, copied to shared memory as soon as the pop
// is read.  Record p holds the rows of links[p, 0 .. maxM), so where a
// slot's row lies is known before its link arrives: the copies need no
// dependent latency, and phase 3 reads shared memory.  Thread j issues
// popped row j's copies (the copy engine's cp.async.bulk: one for the
// record, one for its scales), or none where the row does not expand, and
// arrives on the barrier with their bytes (T arrivals a phase); the block
// waits before phase 2's barrier (wait_records).  A rows source stages its
// slots' rows instead (stage_row).
template <int kElem, int kThreads>
__device__ __forceinline__ void stage_records(const RowSource& src,
                                              const int* pop_i,
                                              const float* pop_d,
                                              float lower, int T, int maxM,
                                              int D, const RecStage& rs,
                                              int tid) {
  constexpr bool kI8 = elem_type(kElem) == kElemI8;
  if (!src.records) return;
  const unsigned record = (unsigned)maxM * D * (kI8 ? 1 : 2);
  const unsigned scales = kI8 ? (unsigned)maxM * 4 : 0u;
  const unsigned char* rec = static_cast<const unsigned char*>(src.rows);
  for (int j = tid; j < T; j += kThreads) {
    const int p = pop_i[j];
    const bool go = p >= 0 && !(pop_d[j] > lower);
    // the region's earlier readers are done (two block barriers ago)
    // before the copy engine writes it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_expect(rs.bar, go ? record + scales : 0u);
    if (go) {
      bulk_copy(rs.rows + (size_t)j * record, rec + (size_t)p * record,
                record, rs.bar);
      if (kI8)
        bulk_copy(rs.scales + (size_t)j * maxM, src.scales + (size_t)p * maxM,
                  scales, rs.bar);
    }
  }
}

// Phase 2 (int8 / bf16 rows, staged): slot s's row, and an int8 row's
// scale, copied to shared memory as the dedupe finds the slot processed
// (``id``; -1: not processed).  A row's place is its link's value, so its
// copy can start no earlier than phase 1; copying every valid slot there,
// as its link lands, overlapped more but moved ~twice the rows (dedupe
// drops about half the slots at T = 8) and ran no faster (graph_probe
// --mode rows' rows-phase-1).  The slot's thread arrives on the barrier
// with the row's bytes, 0 for a slot not processed (T maxM arrivals a
// phase), and has the copy engine copy the row (cp.async.bulk) to rows +
// s D, where a staged record puts slot s's row; the scale, 4 bytes (below
// the bulk copy's 16), goes to scales[s] by a cp.async that its thread
// waits for before phase 2's barrier (cp_async_wait_all).  Phase 3 reads
// them as it reads staged records.
template <int kElem>
__device__ __forceinline__ void stage_row(const RowSource& src,
                                          const RecStage& rs, int s, int id,
                                          int D) {
  constexpr bool kI8 = elem_type(kElem) == kElemI8;
  const unsigned row = (unsigned)D * (kI8 ? 1 : 2);
  mbar_arrive_expect(rs.bar, id >= 0 ? row : 0u);
  if (id >= 0) {
    // the region's earlier readers are done (two block barriers ago)
    // before the copy engine writes it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_copy(rs.rows + (size_t)s * row,
              static_cast<const unsigned char*>(src.rows) + (size_t)id * row,
              row, rs.bar);
    if (kI8) cp_async(rs.scales + s, src.scales + id, 4);
  }
}

// Phase 2 (float32 records, a ring of K rows): the row of processed slot
// s (record pop_i[s / maxM], row s % maxM), compacted to entry ``e`` (-1:
// not processed), copied by the copy engine to ring row e where e < K;
// past K phase 3 reads it from the records (an L2 prefetch of those rows
// here measured 0.3% slower at T = 4: graph_probe's ring-prefetch).
// A records row's place follows from the pop, not from its link, but the
// dedupe decides which slots need one: ring rows go to the processed
// slots alone, every byte of them the walk's bound, in the order phase 3
// scores them.  The slot's thread arrives on the barrier with the row's
// bytes, 0 for a slot not copied (T maxM arrivals a phase, as
// stage_row's).
__device__ __forceinline__ void stage_ring_row(const RowSource& src,
                                               const RecStage& rs,
                                               const int* pop_i, int s,
                                               int e, int maxM, int D) {
  const unsigned row = (unsigned)D * 4;
  const bool copy = e >= 0 && e < src.ring;
  mbar_arrive_expect(rs.bar, copy ? row : 0u);
  if (!copy) return;
  const int j = s / maxM;
  const unsigned char* from =
      static_cast<const unsigned char*>(src.rows) +
      ((size_t)pop_i[j] * maxM + (s - j * maxM)) * row;
  // the ring's earlier readers are done (two block barriers ago) before the
  // copy engine writes it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bulk_copy(rs.rows + (size_t)e * row, from, row, rs.bar);
}

// The arrivals a phase of a staged source's barrier: one a popped row
// (records, stage_records), one a slot (rows, stage_row).
__device__ __forceinline__ unsigned stage_arrivals(const RowSource& src,
                                                  int T, int tm) {
  return src.records ? T : tm;
}

// The step's staged records have landed (phase 3 reads them): each thread
// waits for the barrier's phase of the step (``step`` parity).
__device__ __forceinline__ void wait_records(const RecStage& rs, int step) {
  mbar_wait(rs.bar, (unsigned)step & 1u);
}

// A PQ walk's table and staged codes (pq_place): kElemPQ's both in the
// block's PQ region ``region`` in shared memory, the codes after the
// table; kElemPQFar's table there too, or in device memory
// (src.pq_tables, a table a query), and no staged codes (null: each row's
// codes read from the records).
struct PqTable {
  float* tab;
  unsigned char* staged;
};

template <int kElem>
__device__ __forceinline__ PqTable pq_table(const RowSource& src, int metric,
                                            unsigned char* region, int b) {
  const size_t table = pq_table_bytes(src.groups, metric);
  if constexpr (kElem == kElemPQ) {
    return {reinterpret_cast<float*>(region), region + table};
  } else {
    if (src.pq_tables) return {src.pq_tables + b * (table / 4), nullptr};
    return {reinterpret_cast<float*>(region), nullptr};
  }
}

// The shared bytes of a PQ walk's region (pq_place's choice, as the
// instance and src.pq_tables carry it).
template <int kElem>
__device__ __forceinline__ size_t pq_region_bytes(const RowSource& src,
                                                  int metric, int T,
                                                  int maxM) {
  const size_t table = pq_table_bytes(src.groups, metric);
  if constexpr (kElem == kElemPQ)
    return table + pq_code_bytes(src.groups, T, maxM);
  else
    return src.pq_tables ? 0 : table;
}

// Phase 1 (PQ): the step's codes, copied to shared memory beside the links'
// loads.  Slot s of popped row j (record p = pop_i[j], slot r) holds the
// code of links[p, r]: where it lies is known before the link arrives, so
// the copy needs no dependent latency; phase 3 reads a slot's G bytes at
// staged + s G (waited for before phase 2's barrier: cp_async_wait_all).
// 8- or 4-byte copies where G and the records' alignment allow, else byte
// by byte.
template <int kThreads>
__device__ __forceinline__ void stage_pq_codes(const RowSource& src,
                                               const int* pop_i,
                                               const float* pop_d,
                                               float lower, int maxM, int tm,
                                               unsigned char* staged,
                                               int tid) {
  const int G = src.groups;
  const unsigned char* rec = reinterpret_cast<const unsigned char*>(src.rows);
  const uintptr_t base = reinterpret_cast<uintptr_t>(rec);
  const int chunk = G % 8 == 0 && base % 8 == 0   ? 8
                    : G % 4 == 0 && base % 4 == 0 ? 4
                                                  : 1;
  for (int s = tid; s < tm; s += kThreads) {
    const int j = s / maxM, p = pop_i[j];
    if (p < 0 || pop_d[j] > lower) continue;
    const unsigned char* from = rec + ((size_t)p * maxM + (s - j * maxM)) * G;
    unsigned char* to = staged + (size_t)s * G;
    if (chunk > 1) {
      for (int i = 0; i < G; i += chunk) cp_async(to + i, from + i, chunk);
    } else {
      for (int i = 0; i < G; ++i) to[i] = __ldg(from + i);
    }
  }
}

// The query's PQ distance table, built once a walk by the whole block:
// entry (k, g) at k * G + g (the group minor: a warp's lanes, one group
// each, read 32 banks) is accum's sums over group g's elements of centroid
// k against the query, from 0 in element order, each operation rounded:
// L2 sum (c - q)^2, Manhattan sum |c - q|, cosine (sum c q, sum c^2) as a
// float2.  Consecutive threads take consecutive entries, so the stores
// are conflict-free; the centroids come from L2 (the codebook is read
// from device memory once a launch).  The blocks that start together
// build at once, bound by L2's bandwidth: a thread's entries one at a
// time (two or four with their loads in flight spill, and gain 1% at
// best: PERF.md).
template <int kMetric, int kThreads>
__device__ __forceinline__ void build_pq_table_m(const RowSource& src,
                                                 const float* q_s,
                                                 float* tab, int tid) {
  const int G = src.groups, sub = src.sub;
  for (int i = tid; i < 256 * G; i += kThreads) {
    const int k = i / G, g = i - k * G;
    const float* c = src.codebook + ((size_t)g * 256 + k) * sub;
    const float* q = q_s + g * sub;
    float a = 0.f, pp = 0.f;
    if (src.vec) {
      for (int j = 0; j < sub; j += 4) {
        const float4 cv = __ldg(reinterpret_cast<const float4*>(c + j));
        const float4 qv = *reinterpret_cast<const float4*>(q + j);
        accum<kMetric>(cv.x, qv.x, a, pp);
        accum<kMetric>(cv.y, qv.y, a, pp);
        accum<kMetric>(cv.z, qv.z, a, pp);
        accum<kMetric>(cv.w, qv.w, a, pp);
      }
    } else {
      for (int j = 0; j < sub; ++j) accum<kMetric>(__ldg(c + j), q[j], a, pp);
    }
    if (kMetric == kMetricCosine)
      reinterpret_cast<float2*>(tab)[i] = make_float2(a, pp);
    else
      tab[i] = a;
  }
}

template <int kThreads>
__device__ __forceinline__ void build_pq_table(const RowSource& src,
                                               int metric, const float* q_s,
                                               float* tab, int tid) {
  if (metric == kMetricL2)
    build_pq_table_m<kMetricL2, kThreads>(src, q_s, tab, tid);
  else if (metric == kMetricCosine)
    build_pq_table_m<kMetricCosine, kThreads>(src, q_s, tab, tid);
  else
    build_pq_table_m<kMetricManhattan, kThreads>(src, q_s, tab, tid);
}

// The butterfly levels (offsets O, O/2, ...) that also halve the rows a
// lane carries: at each, a lane keeps the upper half of its H + H rows if
// its offset bit is set, else the lower, and adds the partner's partial of
// the rows it keeps.
template <int H, int O, int R>
__device__ __forceinline__ void halve_rows(float (&v)[R], int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float keep = up ? v[i + H] : v[i];
      const float send = up ? v[i] : v[i + H];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, O));
    }
    halve_rows<H / 2, O / 2, R>(v, lane);
  }
}

// The sums over the warp of R rows' lane partials: lane l returns the sum
// of row l / (32 / R).  Each row's sum is the same tree of additions as a
// plain butterfly over the lanes (xor 16, 8, ..., 1), so the same bits,
// for R - 1 + 5 - log2(R) shuffles in all instead of 5 R.
template <int R>
__device__ __forceinline__ float rows_sum(float (&v)[R], int lane) {
  halve_rows<R / 2, 16, R>(v, lane);
#pragma unroll
  for (int o = 16 / R; o > 0; o >>= 1)
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], o));
  return v[0];
}

// Count of sorted v[0, n) strictly below x (lower bound).
__device__ __forceinline__ int count_below(const float* v, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Count of sorted v[0, n) at or below x (upper bound).
__device__ __forceinline__ int count_at_or_below(const float* v, int n,
                                                 float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Entry x of a queue kept as a ring of ``ring`` entries from ``head``
// (head < ring, x < ring).
__device__ __forceinline__ int ring_at(int head, int ring, int x) {
  const int p = head + x;
  return p >= ring ? p - ring : p;
}

// Count of the ring queue's sorted entries [0, n) from ``head`` at or
// below x (upper bound).
__device__ __forceinline__ int ring_count_at_or_below(const float* v,
                                                      int head, int ring,
                                                      int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[ring_at(head, ring, mid)] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Phase 4: the n_new admitted new_ds (d, slot bits) ranked by (d, slot)
// into srt_d / srt_i (the slot's id).  g lanes an entry (a power of two up
// to 32, as many as the block has threads to spare), each counting a g-th
// of the entries below it, then a shuffle sum over the g.
template <int kThreads>
__device__ __forceinline__ void rank_admitted(const float2* new_ds, int n_new,
                                              const int* slot_id,
                                              float* srt_d, int* srt_i,
                                              int tid) {
  int g = 1;
  while (g < 32 && 2 * g * n_new <= kThreads) g *= 2;
  for (int t0 = 0; t0 < n_new * g; t0 += kThreads) {   // uniform
    const int e = (t0 + tid) / g, q = (t0 + tid) % g;
    float2 me = make_float2(0.f, 0.f);
    int below = 0;
    if (e < n_new) {
      me = new_ds[e];
      const int s = __float_as_int(me.y);
#pragma unroll 8
      for (int f = q; f < n_new; f += g) {
        const float2 o = new_ds[f];
        below += o.x < me.x || (o.x == me.x && __float_as_int(o.y) < s);
      }
    }
    for (int o = g / 2; o > 0; o >>= 1)
      below += __shfl_xor_sync(kFull, below, o);
    if (e < n_new && q == 0) {
      srt_d[below] = me.x;
      srt_i[below] = slot_id[__float_as_int(me.y)];
    }
  }
}

// Phase 3's visited-set writes, once every slot has read the set: the
// bitmap's processed ids set their bits (atomicOr), or the last warp
// writes the hash table's slots in 32-slot chunks in slot order, a match
// among the
// chunk's lanes leaving the highest slot of each table slot to write it
// (proc_bits: the processed slots, a word a 32-slot chunk).  ``vis`` is
// the set in shared or device memory, the same code through a pointer.
template <int kThreads>
__device__ __forceinline__ void record_visits(int vis_mode, int* vis,
                                              int vis_n, const int* proc,
                                              int n_proc, const int* slot_id,
                                              const unsigned* proc_bits,
                                              int tm, int tid, int warp,
                                              int lane) {
  if (vis_mode == kVisBitmap) {
    for (int e = tid; e < n_proc; e += kThreads) {
      const int id = slot_id[proc[e]];
      atomicOr(reinterpret_cast<unsigned*>(vis) + (id >> 5),
               1u << (id & 31));
    }
  } else if (vis_mode == kVisHash && warp == kThreads / 32 - 1) {
    // in slot order, a chunk of 32 slots at a time: of the chunk's slots
    // that write one table slot the highest writes, and a later chunk's
    // write lands after (__syncwarp orders them).  The last warp writes
    // (phase 3's rows fall to the first warps first), and reads each
    // chunk's processed bits and ids a chunk ahead, so the reads do not
    // wait behind the writes; a chunk with none processed is skipped.
    unsigned bits = proc_bits[0];
    int id = lane < tm ? slot_id[lane] : 0;
    for (int c = 0; c * 32 < tm; ++c) {
      const int next = (c + 1) * 32 + lane;
      const unsigned next_bits = next - lane < tm ? proc_bits[c + 1] : 0u;
      const int next_id = next < tm ? slot_id[next] : 0;
      if (bits) {                                   // uniform
        const bool mine = (bits >> lane) & 1u;
        const int at = mine ? vis_slot(id, vis_n) : -1 - lane;
        const unsigned peers = __match_any_sync(kFull, at);
        if (mine && lane == 31 - __clz(peers)) vis[at] = id;
        __syncwarp();
      }
      bits = next_bits;
      id = next_id;
    }
  }
}

// Phase 3's distances: each warp scores kRowsPerWarp processed slots at a
// time (their row loads issued together), and appends those below lower to
// new_ds (d, slot bits) with one atomic a warp.  PQ rows: each lane reads
// its groups' code bytes of the warp's rows (staged in shared memory by
// phase 1, or from the records), then adds their entries of the query's
// table ``pq.tab`` (build_pq_table) into its partials.  Staged records
// or rows: each slot's row and scale from ``rs`` in shared memory
// (stage_records, stage_row), widened and summed as the records' are.
template <int kMetric, int kElem, int kWarps>
__device__ __forceinline__ void score_rows(
    const RowSource& src, const float* q_s, const PqTable& pq,
    const RecStage& rs, int D, int maxM, float qq, float lower,
    const int* proc, int n_proc, const int* slot_id, const int* ci,
    int* n_new, float2* new_ds, int warp, int lane) {
  constexpr int R = kRowsPerWarp, kLanesPerRow = 32 / R;
  constexpr int kType = elem_type(kElem);     // the rows' element type
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  for (int e0 = warp * R; e0 < n_proc; e0 += kWarps * R) {
    // each row's index in the rows or records (-1: none), 32 bits to spare
    // registers
    int at[R];
    float a[R], pp[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      a[u] = pp[u] = 0.f;
      at[u] = -1;
      if (e0 + u < n_proc) {
        const int s = proc[e0 + u];
        // (PQ and staged records or rows: the slot, whose codes or row
        // phase 1 staged; a ring: the entry, whose row phase 2 copied to
        // that ring row; else the record or the row)
        if constexpr (is_ring(kElem)) {
          at[u] = e0 + u;
        } else {
          at[u] = kElem == kElemPQ || is_staged(kElem) ? s
                  : src.records ? ci[s / maxM] * maxM + s % maxM
                                : slot_id[s];
        }
      }
    }
    // per chunk of a row: every row's raw elements and int8 scale, then
    // the widening and the sums
    float sc[R];
    if constexpr (is_pq(kElem)) {
      const int G = src.groups;
      const float* tab = pq.tab;
      const unsigned char* rec = static_cast<const unsigned char*>(src.rows);
      for (int g = lane; g < G; g += 32) {
        int code[R];
#pragma unroll
        for (int u = 0; u < R; ++u)
          code[u] = at[u] < 0 ? 0
                    : kElem == kElemPQ ? pq.staged[at[u] * G + g]
                                       : __ldg(rec + (size_t)at[u] * G + g);
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (at[u] < 0) continue;
          if (kMetric == kMetricCosine) {
            const float2 t =
                reinterpret_cast<const float2*>(tab)[code[u] * G + g];
            a[u] = __fadd_rn(a[u], t.x);
            pp[u] = __fadd_rn(pp[u], t.y);
          } else {
            a[u] = __fadd_rn(a[u], tab[code[u] * G + g]);
          }
        }
      }
    } else if (src.vec) {
      for (int c = lane; c < D / 4; c += 32) {
        const float4 qv = q4[c];
        typename Raw<kElem>::Vec raw[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (at[u] < 0) continue;
          raw[u] = load4<kElem>(src, rs, at[u], c, D);
          if (kType == kElemI8) sc[u] = scale_at<kElem>(src, rs, at[u]);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (at[u] < 0) continue;
          const float4 pv =
              widen4<kType>(raw[u], kType == kElemI8 ? sc[u] : 1.f);
          accum<kMetric>(pv.x, qv.x, a[u], pp[u]);
          accum<kMetric>(pv.y, qv.y, a[u], pp[u]);
          accum<kMetric>(pv.z, qv.z, a[u], pp[u]);
          accum<kMetric>(pv.w, qv.w, a[u], pp[u]);
        }
      }
    } else {
      for (int c = lane; c < D; c += 32) {
        const float qv = q_s[c];
        typename Raw<kElem>::One raw[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (at[u] < 0) continue;
          raw[u] = load1<kElem>(src, rs, at[u], c, D);
          if (kType == kElemI8) sc[u] = scale_at<kElem>(src, rs, at[u]);
        }
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (at[u] >= 0)
            accum<kMetric>(
                widen1<kType>(raw[u], kType == kElemI8 ? sc[u] : 1.f), qv,
                a[u], pp[u]);
      }
    }
    // lane l holds row l / kLanesPerRow's sums; its group's first lane
    // takes the verdict
    const int row = lane / kLanesPerRow;
    const float s_a = rows_sum<R>(a, lane);
    float d;
    if (kMetric == kMetricL2) {
      d = sqrtf(s_a);
    } else if (kMetric == kMetricCosine) {
      float s_pp = rows_sum<R>(pp, lane);
      if (kType == kElemBF16 && src.round_pp)
        s_pp = __bfloat162float(__float2bfloat16_rn(s_pp));
      d = __fsub_rn(1.f, __fmul_rn(s_a, rsqrtf(fmaxf(__fmul_rn(qq, s_pp),
                                                      1e-30f))));
    } else {
      d = s_a;
    }
    const bool admit =
        lane % kLanesPerRow == 0 && e0 + row < n_proc && d < lower;
    const unsigned m = __ballot_sync(kFull, admit);
    if (m) {
      int at0 = 0;
      if (lane == 0) at0 = atomicAdd(n_new, __popc(m));
      const int o = __shfl_sync(kFull, at0, 0) +
                    __popc(m & ((1u << lane) - 1u));
      if (admit) new_ds[o] = make_float2(d, __int_as_float(proc[e0 + row]));
    }
  }
}

// Phase 3 of a float32 records ring: the entries past the ring first, from
// the records, while the ring's copies land (waiting first measured 1.2%
// slower at T = 4: graph_probe's ring-wait-first), then, once the step's
// barrier phase has ended, the first min(K, n_proc) entries from the
// ring.  Each pass is score_rows over one
// source (the records' kElemF32, the ring's shared reads): no choice of
// memory per row, and no more live registers than either.  The admitted
// go to new_ds in another order; the rank orders them by (d, slot), so
// the walk is the same.
template <int kWarps>
__device__ __forceinline__ void score_ring(
    const RowSource& src, const float* q_s, const PqTable& pq,
    const RecStage& rs, int D, int maxM, float qq, float lower,
    const int* proc, int n_proc, const int* slot_id, const int* ci,
    int* n_new, float2* new_ds, int warp, int lane, int metric, int step) {
  const int k = min(src.ring, n_proc);
  if (metric == kMetricL2)
    score_rows<kMetricL2, kElemF32, kWarps>(src, q_s, pq, rs, D, maxM, qq,
                                            lower, proc + k, n_proc - k,
                                            slot_id, ci, n_new, new_ds, warp,
                                            lane);
  else if (metric == kMetricCosine)
    score_rows<kMetricCosine, kElemF32, kWarps>(
        src, q_s, pq, rs, D, maxM, qq, lower, proc + k, n_proc - k, slot_id,
        ci, n_new, new_ds, warp, lane);
  else
    score_rows<kMetricManhattan, kElemF32, kWarps>(
        src, q_s, pq, rs, D, maxM, qq, lower, proc + k, n_proc - k, slot_id,
        ci, n_new, new_ds, warp, lane);
  wait_records(rs, step);
  if (metric == kMetricL2)
    score_rows<kMetricL2, kElemF32Staged, kWarps>(
        src, q_s, pq, rs, D, maxM, qq, lower, proc, k, slot_id, ci, n_new,
        new_ds, warp, lane);
  else if (metric == kMetricCosine)
    score_rows<kMetricCosine, kElemF32Staged, kWarps>(
        src, q_s, pq, rs, D, maxM, qq, lower, proc, k, slot_id, ci, n_new,
        new_ds, warp, lane);
  else
    score_rows<kMetricManhattan, kElemF32Staged, kWarps>(
        src, q_s, pq, rs, D, maxM, qq, lower, proc, k, slot_id, ci, n_new,
        new_ds, warp, lane);
}

template <int kElem, bool kDense, int kThreads>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kThreads>)
beam_walk_kernel(const int* __restrict__ links, const int* __restrict__ counts,
                 const RowSource src, const float* __restrict__ queries,
                 const float* __restrict__ entry_d, int* visited,
                 int has_nodes, int D, int maxM, int T, int ef, int cap,
                 int metric, int vis_set, int vis_n, int held_n, int slot_n,
                 float* __restrict__ out_d, int* __restrict__ out_i,
                 int* __restrict__ out_hops, int* __restrict__ out_evals) {
  constexpr int kWarps = kThreads / 32;
  // the dense dedupe's instances compile the visited sets' branches away
  const int vis_mode = kDense ? kVisDense : vis_set;
  extern __shared__ __align__(16) unsigned char smem[];
  const float kInf = __int_as_float(0x7f800000);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tm = T * maxM;
  const int Dp = (D + 3) / 4 * 4;
  const bool hashed = held_n > 0;
  Laps laps;
  laps.start();
  float* q_s = reinterpret_cast<float*>(smem);
  float* rd = q_s + Dp;
  float* rd_n = rd + ef;
  float* cd = rd_n + ef;
  float* cd_n = cd + cap;
  int* ri = reinterpret_cast<int*>(cd_n + cap);
  int* ri_n = ri + ef;
  int* ci = ri_n + ef;
  int* ci_n = ci + cap;
  int* slot_id = ci_n + cap;
  int* proc = slot_id + tm;
  float2* new_ds = reinterpret_cast<float2*>(proc + tm);   // 8-aligned
  float* srt_d = reinterpret_cast<float*>(new_ds + tm);
  int* srt_i = reinterpret_cast<int*>(srt_d + tm);
  int* ctr = srt_i + tm;         // [processed, admitted] x step parity, |q|^2
  int* held = ctr + 8;
  int* slot_key = held + held_n;
  int* slot_min = slot_key + slot_n;
  // a PQ source's distance table and staged codes (pq_table; shared memory
  // 8-aligned: every offset before it is), or its table in device memory
  unsigned char* region = reinterpret_cast<unsigned char*>(slot_min + slot_n);
  PqTable pq{nullptr, nullptr};
  if constexpr (is_pq(kElem)) pq = pq_table<kElem>(src, metric, region, b);
  // a staged records or rows source's rows and scales there (16-aligned:
  // records_place), their barrier in the counters (set only in its
  // instances: a stage built in the others, though unused, renumbers the
  // float32 instances' registers and moves their ptxas spills)
  RecStage rs{nullptr, nullptr, nullptr};
  if constexpr (is_staged(kElem) || is_ring(kElem))
    rs = rec_stage<kElem>(region, ctr, T, maxM, D);
  // the hash set's processed slots, a word a 32-slot chunk, from phase 2 to
  // phase 3's writes (srt_i is next written in phase 4)
  unsigned* proc_bits = reinterpret_cast<unsigned*>(srt_i);
  // this query's visited set, bitmap words or hash-table slots: in device
  // memory, or, where the launch keeps it in shared memory (vis_place:
  // ``visited`` null), after every other part from a 16-byte boundary (the
  // offset is the layout's: a set found at the end of the dynamic shared
  // memory instead, by %dynamic_smem_size, moved the 256-thread instance's
  // spill loads from 928 to 1,092 B and cost its walks 6%)
  int* vis = nullptr;
  if constexpr (!kDense) {
    if (visited) {
      vis = visited + (size_t)b * vis_n;
    } else {
      size_t at = region - smem;
      if constexpr (is_pq(kElem))
        at += pq_region_bytes<kElem>(src, metric, T, maxM);
      if constexpr (is_staged(kElem))
        at += rec_stage_bytes(elem_type(kElem) == kElemI8 ? 1 : 2,
                              elem_type(kElem) == kElemI8, T, maxM, D);
      if constexpr (is_ring(kElem)) at += (size_t)src.ring * D * 4;
      vis = reinterpret_cast<int*>(smem + round16(at));
    }
  }

  const float* q = queries + (size_t)b * D;
  for (int i = tid; i < Dp; i += kThreads) q_s[i] = i < D ? q[i] : 0.f;
  for (int i = tid; i < ef; i += kThreads) { rd[i] = kInf; ri[i] = -1; }
  for (int i = tid; i < cap; i += kThreads) { cd[i] = kInf; ci[i] = -1; }
  for (int i = tid; i < held_n; i += kThreads) held[i] = kEmpty;
  for (int i = tid; i < slot_n; i += kThreads) {
    slot_key[i] = kEmpty;
    slot_min[i] = INT_MAX;
  }
  // a set in shared memory starts empty: the bitmap zeroed, the hash table
  // -1 (the wrapper fills one in device memory so)
  if constexpr (!kDense)
    if (!visited)
      for (int i = tid; i < vis_n; i += kThreads)
        vis[i] = vis_mode == kVisHash ? kEmpty : 0;
  if (tid < 4) ctr[tid] = 0;
  if constexpr (is_staged(kElem))
    if (tid == 0) mbar_init(rs.bar, stage_arrivals(src, T, tm));
  if constexpr (is_ring(kElem))
    if (tid == 0) mbar_init(rs.bar, tm);       // stage_ring_row: one a slot
  __syncthreads();
  if (tid == 0 && has_nodes) {
    rd[0] = cd[0] = entry_d[b];
    ri[0] = ci[0] = 0;
    // node 0 visited: its bit, or slot 0 of its bucket
    if constexpr (!kDense)
      if (!visited) vis[0] = vis_mode == kVisHash ? 0 : 1;
  }
  if (metric == kMetricCosine && warp == 0) {
    float s = 0.f;
    for (int i = lane; i < D; i += 32)
      s = __fadd_rn(s, __fmul_rn(q_s[i], q_s[i]));
    s = warp_sum(s);
    if (lane == 0) ctr[4] = __float_as_int(s);
  }
  if constexpr (is_pq(kElem))
    build_pq_table<kThreads>(src, metric, q_s, pq.tab, tid);
  __syncthreads();
  const float qq = __int_as_float(ctr[4]);
  int hops = 0, evals = 0;
  if (tid == 0) laps.lap(kLapSetup);

  while (true) {
    const float c0 = cd[0], lower = rd[ef - 1];
    if (!(c0 < kInf && !(c0 > lower))) break;   // uniform: shared reads
    // overwritten hash entries can re-admit expanded nodes: the hop cap
    if (vis_mode == kVisHash && hops >= vis_n) break;
    // this step's counters; the next step's are zeroed here (their last
    // reader finished before the previous step's final barrier)
    int* cnt = ctr + 2 * (hops & 1);
    if (tid == 0) ctr[2 - 2 * (hops & 1)] = ctr[3 - 2 * (hops & 1)] = 0;

    // --- 1. the popped rows' links (ci[0, T) is the pop); table inserts.
    // Slot s's loads: its row's count less its place in the row, and its
    // link (both in flight together).
    auto load_slot = [&](int s, int& left, int& link) {
      const int j = s / maxM, r = s - j * maxM;
      const int p = ci[j];
      left = 0;
      link = -1;
      if (p >= 0 && !(cd[j] > lower)) {
        left = __ldg(counts + p) - r;
        link = __ldg(links + (size_t)p * maxM + r);
      }
    };
    int left = 0, link = -1;
    if (tid < tm) load_slot(tid, left, link);   // in flight over the inserts
    if constexpr (kElem == kElemPQ)
      stage_pq_codes<kThreads>(src, ci, cd, lower, maxM, tm, pq.staged, tid);
    if constexpr (is_staged(kElem))
      stage_records<kElem, kThreads>(src, ci, cd, lower, T, maxM, D, rs, tid);
    if (hashed && vis_mode == kVisDense) {
      for (int i = tid; i < cap + ef; i += kThreads) {
        const int id = i < cap ? ci[i] : ri[i - cap];
        if (id >= 0) held_insert(held, held_n, id);
      }
    }
    // a visited set: slot tid's set words (vis_word), read as its link
    // lands and held in registers till phase 2 (the set changes only in
    // phase 3, two barriers before the next step's reads)
    int4 pre = make_int4(0, 0, 0, 0);
    for (int s = tid; s < tm; s += kThreads) {
      if (s != tid) load_slot(s, left, link);
      const int id = left > 0 && link >= 0 ? link : -1;
      slot_id[s] = id;
      if constexpr (!kDense)
        if (s == tid && id >= 0) pre = vis_word(vis, vis_mode, vis_n, id);
      if (hashed && id >= 0) slot_insert(slot_key, slot_min, slot_n, id, s);
    }
    __syncthreads();
    if (tid == 0) laps.lap(kLapLinks);

    // --- 2. dedupe; compact the processed slots, an atomic a warp
    for (int s0 = warp * 32; s0 < tm; s0 += kThreads) {
      const int s = s0 + lane;
      const int id = s < tm ? slot_id[s] : -1;
      bool keep = id >= 0;
      if (keep && vis_mode == kVisDense && hashed) {
        keep = !held_has(held, held_n, id) &&
               slot_first(slot_key, slot_min, slot_n, id) == s;
      } else if (keep && vis_mode == kVisDense) {
        for (int k = 0; keep && k < cap; ++k) keep = ci[k] != id;
        for (int k = 0; keep && k < ef; ++k) keep = ri[k] != id;
        for (int k = 0; keep && k < s; ++k) keep = slot_id[k] != id;
      } else if (keep) {
        // the first slot of its id, then unvisited by the set (slot tid's
        // words read in phase 1, a later slot's here)
        if (hashed) {
          keep = slot_first(slot_key, slot_min, slot_n, id) == s;
        } else {
          for (int k = 0; keep && k < s; ++k) keep = slot_id[k] != id;
        }
        keep = keep && !vis_holds(s == tid ? pre
                                           : vis_word(vis, vis_mode, vis_n, id),
                                  vis_mode, id);
      }
      const unsigned m = __ballot_sync(kFull, keep);
      // a staged rows source: each processed slot's row copied as the
      // dedupe keeps it (stage_row)
      if constexpr (is_staged(kElem))
        if (!src.records && s < tm)
          stage_row<kElem>(src, rs, s, keep ? id : -1, D);
      if (vis_mode == kVisHash && lane == 0) proc_bits[s0 >> 5] = m;
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&cnt[0], __popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (keep) proc[at + __popc(m & ((1u << lane) - 1u))] = s;
      // float32 records in a ring: each processed slot's row copied to its
      // compacted entry below K (stage_ring_row)
      if constexpr (is_ring(kElem))
        if (s < tm)
          stage_ring_row(src, rs, ci, s,
                         keep ? at + __popc(m & ((1u << lane) - 1u)) : -1,
                         maxM, D);
    }
    // the staged PQ codes, records or rows and scales have landed (phase 3
    // reads them)
    if constexpr (kElem == kElemPQ || kElem == kElemI8Staged)
      cp_async_wait_all();
    if constexpr (is_staged(kElem)) wait_records(rs, hops);
    __syncthreads();
    const int n_proc = cnt[0];
    if (tid == 0) laps.lap(kLapDedupe);

    // --- 3. the tables' last reader is done: clear them for the next step
    for (int i = tid; i < held_n; i += kThreads) held[i] = kEmpty;
    for (int i = tid; i < slot_n; i += kThreads) {
      slot_key[i] = kEmpty;
      slot_min[i] = INT_MAX;
    }
    // every slot has read the visited set: the processed ids enter it (the
    // next step reads it after two barriers)
    record_visits<kThreads>(vis_mode, vis, vis_n, proc, n_proc, slot_id,
                            proc_bits, tm, tid, warp, lane);
    // distances, kRowsPerWarp neighbours a warp at a time; admit
    if constexpr (is_ring(kElem)) {
      score_ring<kWarps>(src, q_s, pq, rs, D, maxM, qq, lower, proc, n_proc,
                         slot_id, ci, cnt + 1, new_ds, warp, lane, metric,
                         hops);
    } else if (metric == kMetricL2) {
      score_rows<kMetricL2, kElem, kWarps>(src, q_s, pq, rs, D, maxM, qq,
                                           lower, proc, n_proc, slot_id, ci,
                                           cnt + 1, new_ds, warp, lane);
    } else if (metric == kMetricCosine) {
      score_rows<kMetricCosine, kElem, kWarps>(src, q_s, pq, rs, D, maxM,
                                               qq, lower, proc, n_proc,
                                               slot_id, ci, cnt + 1, new_ds,
                                               warp, lane);
    } else {
      score_rows<kMetricManhattan, kElem, kWarps>(
          src, q_s, pq, rs, D, maxM, qq, lower, proc, n_proc, slot_id, ci,
          cnt + 1, new_ds, warp, lane);
    }
    __syncthreads();
    const int n_new = cnt[1];
    if (tid == 0) laps.lap(kLapRows);

    // --- 4. rank the admitted by (d, slot); 5. merge both queues by rank
    if (n_new > 0) {
      const int rest = cap - T;          // incumbents after the pop
      // the admitted ranked by (d, slot) into srt, then each queue merged
      // by binary searches
      rank_admitted<kThreads>(new_ds, n_new, slot_id, srt_d, srt_i, tid);
      __syncthreads();
      if (tid == 0) laps.lap(kLapRank);
      for (int p = tid; p < ef; p += kThreads) {
        const int o = p + count_below(srt_d, n_new, rd[p]);
        if (o < ef) { rd_n[o] = rd[p]; ri_n[o] = ri[p]; }
      }
      for (int e = tid; e < n_new; e += kThreads) {
        const int o = e + count_at_or_below(rd, ef, srt_d[e]);
        if (o < ef) { rd_n[o] = srt_d[e]; ri_n[o] = srt_i[e]; }
      }
      for (int p = tid; p < rest; p += kThreads) {
        const int o = p + count_below(srt_d, n_new, cd[T + p]);
        if (o < cap) { cd_n[o] = cd[T + p]; ci_n[o] = ci[T + p]; }
      }
      for (int e = tid; e < n_new; e += kThreads) {
        const int o = e + count_at_or_below(cd + T, rest, srt_d[e]);
        if (o < cap) { cd_n[o] = srt_d[e]; ci_n[o] = srt_i[e]; }
      }
      for (int o = rest + n_new + tid; o < cap; o += kThreads) {
        cd_n[o] = kInf;
        ci_n[o] = -1;
      }
      float* tf = rd; rd = rd_n; rd_n = tf;
      int* ti = ri; ri = ri_n; ri_n = ti;
    } else {
      for (int o = tid; o < cap; o += kThreads) {
        cd_n[o] = o + T < cap ? cd[o + T] : kInf;
        ci_n[o] = o + T < cap ? ci[o + T] : -1;
      }
    }
    float* tf = cd; cd = cd_n; cd_n = tf;
    int* ti = ci; ci = ci_n; ci_n = ti;
    ++hops;
    evals += n_proc;
    __syncthreads();
    if (tid == 0) laps.lap(kLapMerge);
  }

  for (int p = tid; p < ef; p += kThreads) {
    out_d[(size_t)b * ef + p] = rd[p];
    out_i[(size_t)b * ef + p] = ri[p];
  }
  if (tid == 0) {
    out_hops[b] = hops;
    out_evals[b] = evals;
    laps.lap(kLapSetup);
    laps.flush(hops);
  }
}

// The wide instances (ef or cap above kMaxQueue; the design note at the
// top): the same step and the same answers, with a held set kept from step
// to step in device memory (``held``, two bits an id: the dense dedupe),
// each queue once, the candidate queue a ring of ``ring`` entries popped by
// its head, and the merge in place.  The queues are in shared memory after
// the slot table where ``queues_shared``, else in device memory after the
// held bits.  Logical entry x of the candidate queue is ring entry
// ring_at(head, ring, x); n_res and n_cand count each queue's entries (the
// rest is padding, and so are the next pop's places past n_cand).
template <int kElem>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks)
beam_walk_wide_kernel(const int* __restrict__ links,
                      const int* __restrict__ counts, const RowSource src,
                      const float* __restrict__ queries,
                      const float* __restrict__ entry_d, int* visited,
                      int* wide_mem, size_t wide_words, size_t held_words,
                      int queues_shared, int has_nodes, int D, int maxM,
                      int T, int ef, int cap, int ring, int metric,
                      int vis_mode, int vis_n, int slot_n,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int* __restrict__ out_hops,
                      int* __restrict__ out_evals) {
  constexpr int kThreads = kWideThreads, kWarps = kThreads / 32;
  constexpr int kChunk = kMoveRun * kThreads;    // incumbents a round
  extern __shared__ __align__(16) unsigned char smem[];
  const float kInf = __int_as_float(0x7f800000);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tm = T * maxM;
  const int Dp = (D + 3) / 4 * 4;
  const bool dense = vis_mode == kVisDense;
  Laps laps;
  laps.start();
  float* q_s = reinterpret_cast<float*>(smem);
  int* slot_id = reinterpret_cast<int*>(q_s + Dp);
  int* proc = slot_id + tm;
  float2* new_ds = reinterpret_cast<float2*>(proc + tm);   // 8-aligned
  float* srt_d = reinterpret_cast<float*>(new_ds + tm);
  int* srt_i = reinterpret_cast<int*>(srt_d + tm);
  int* ctr = srt_i + tm;         // [processed, admitted] x step parity, |q|^2
  int* slot_key = ctr + 8;
  int* slot_min = slot_key + slot_n;
  int* mine = wide_words ? wide_mem + b * wide_words : nullptr;
  unsigned* held = reinterpret_cast<unsigned*>(mine);
  // a PQ source's distance table and staged codes after the slot table (or
  // its table in device memory: pq_table), or a staged records or rows
  // source's rows and scales (records_place), then the queues where they
  // are in shared memory
  unsigned char* region = reinterpret_cast<unsigned char*>(slot_min + slot_n);
  PqTable pq{nullptr, nullptr};
  if constexpr (is_pq(kElem)) pq = pq_table<kElem>(src, metric, region, b);
  size_t region_bytes = 0;
  if constexpr (is_pq(kElem))
    region_bytes = pq_region_bytes<kElem>(src, metric, T, maxM);
  RecStage rs{nullptr, nullptr, nullptr};
  if constexpr (is_staged(kElem)) {
    constexpr bool kI8 = elem_type(kElem) == kElemI8;
    rs = rec_stage<kElem>(region, ctr, T, maxM, D);
    region_bytes = rec_stage_bytes(kI8 ? 1 : 2, kI8, T, maxM, D);
  }
  float* rd = queues_shared ? reinterpret_cast<float*>(region + region_bytes)
                            : reinterpret_cast<float*>(mine + held_words);
  float* cd = rd + ef;
  int* ri = reinterpret_cast<int*>(cd + ring);
  int* ci = ri + ef;
  // from the rank on (the slots' ids and processed slots read): each
  // admitted entry's place in either queue
  int* at_r = proc;
  int* at_c = slot_id;
  unsigned* proc_bits = reinterpret_cast<unsigned*>(srt_i);
  int* vis = dense ? nullptr : visited + (size_t)b * vis_n;

  const float* q = queries + (size_t)b * D;
  for (int i = tid; i < Dp; i += kThreads) q_s[i] = i < D ? q[i] : 0.f;
  for (int i = tid; i < ef; i += kThreads) { rd[i] = kInf; ri[i] = -1; }
  for (int i = tid; i < ring; i += kThreads) { cd[i] = kInf; ci[i] = -1; }
  for (int i = tid; i < slot_n; i += kThreads) {
    slot_key[i] = kEmpty;
    slot_min[i] = INT_MAX;
  }
  if (tid < 4) ctr[tid] = 0;
  if constexpr (is_staged(kElem))
    if (tid == 0) mbar_init(rs.bar, stage_arrivals(src, T, tm));
  __syncthreads();
  if (tid == 0 && has_nodes) {
    rd[0] = cd[0] = entry_d[b];
    ri[0] = ci[0] = 0;
    if (dense) held[0] = kInRes | kInCand;   // node 0's bits (zeroed words)
  }
  if (metric == kMetricCosine && warp == 0) {
    float s = 0.f;
    for (int i = lane; i < D; i += 32)
      s = __fadd_rn(s, __fmul_rn(q_s[i], q_s[i]));
    s = warp_sum(s);
    if (lane == 0) ctr[4] = __float_as_int(s);
  }
  if constexpr (is_pq(kElem))
    build_pq_table<kThreads>(src, metric, q_s, pq.tab, tid);
  __syncthreads();
  const float qq = __int_as_float(ctr[4]);
  int hops = 0, evals = 0;
  int head = 0, n_res = has_nodes ? 1 : 0, n_cand = n_res;   // uniform
  if (tid == 0) laps.lap(kLapSetup);

  while (true) {
    const float* pop_d = cd + head;       // the pop: T entries in a row
    const int* pop_i = ci + head;
    const float c0 = pop_d[0], lower = rd[ef - 1];
    if (!(c0 < kInf && !(c0 > lower))) break;   // uniform: shared reads
    if (vis_mode == kVisHash && hops >= vis_n) break;
    int* cnt = ctr + 2 * (hops & 1);
    if (tid == 0) ctr[2 - 2 * (hops & 1)] = ctr[3 - 2 * (hops & 1)] = 0;

    // --- 1. the popped rows' links; the slot table; each slot's held word
    // or visited-set words (slot tid's in registers till phase 2), read as
    // its link arrives
    if constexpr (kElem == kElemPQ)
      stage_pq_codes<kThreads>(src, pop_i, pop_d, lower, maxM, tm, pq.staged,
                               tid);
    if constexpr (is_staged(kElem))
      stage_records<kElem, kThreads>(src, pop_i, pop_d, lower, T, maxM, D,
                                     rs, tid);
    int4 pre = make_int4(0, 0, 0, 0);       // the held word in .x
    for (int s = tid; s < tm; s += kThreads) {
      const int j = s / maxM, r = s - j * maxM;
      const int p = pop_i[j];
      int id = -1;
      if (p >= 0 && !(pop_d[j] > lower)) {
        const int left = __ldg(counts + p) - r;
        const int link = __ldg(links + (size_t)p * maxM + r);
        if (left > 0 && link >= 0) id = link;
      }
      slot_id[s] = id;
      if (id >= 0) {
        if (s == tid)
          pre = dense ? make_int4((int)__ldcg(held + (id >> 4)), 0, 0, 0)
                      : vis_word(vis, vis_mode, vis_n, id);
        slot_insert(slot_key, slot_min, slot_n, id, s);
      }
    }
    __syncthreads();
    if (tid == 0) laps.lap(kLapLinks);

    // --- 2. dedupe: its id's first slot, and not held (or unvisited by
    // the set); compact the processed slots, an atomic a warp
    for (int s0 = warp * 32; s0 < tm; s0 += kThreads) {
      const int s = s0 + lane;
      const int id = s < tm ? slot_id[s] : -1;
      bool keep = id >= 0 && slot_first(slot_key, slot_min, slot_n, id) == s;
      if (keep && dense) {
        const unsigned w =
            s == tid ? (unsigned)pre.x : __ldcg(held + (id >> 4));
        keep = !((w >> (2 * (id & 15))) & (kInRes | kInCand));
      } else if (keep) {
        keep = !vis_holds(
            s == tid ? pre : vis_word(vis, vis_mode, vis_n, id), vis_mode,
            id);
      }
      const unsigned m = __ballot_sync(kFull, keep);
      // a staged rows source: each processed slot's row copied as the
      // dedupe keeps it (stage_row)
      if constexpr (is_staged(kElem))
        if (!src.records && s < tm)
          stage_row<kElem>(src, rs, s, keep ? id : -1, D);
      if (vis_mode == kVisHash && lane == 0) proc_bits[s0 >> 5] = m;
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&cnt[0], __popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (keep) proc[at + __popc(m & ((1u << lane) - 1u))] = s;
    }
    // the staged PQ codes, records or rows and scales have landed (phase 3
    // reads them)
    if constexpr (kElem == kElemPQ || kElem == kElemI8Staged)
      cp_async_wait_all();
    if constexpr (is_staged(kElem)) wait_records(rs, hops);
    __syncthreads();
    const int n_proc = cnt[0];
    if (tid == 0) laps.lap(kLapDedupe);

    // --- 3. the slot table's last reader is done: clear it; the visited
    // set's writes; the popped ids leave the candidate queue's bits (every
    // slot has read them); distances; admit
    for (int i = tid; i < slot_n; i += kThreads) {
      slot_key[i] = kEmpty;
      slot_min[i] = INT_MAX;
    }
    record_visits<kThreads>(vis_mode, vis, vis_n, proc, n_proc, slot_id,
                            proc_bits, tm, tid, warp, lane);
    for (int j = tid; dense && j < min(T, n_cand); j += kThreads)
      atomicAnd(held + (pop_i[j] >> 4),
                ~(kInCand << (2 * (pop_i[j] & 15))));
    if (metric == kMetricL2)
      score_rows<kMetricL2, kElem, kWarps>(src, q_s, pq, rs, D, maxM, qq,
                                           lower, proc, n_proc, slot_id,
                                           pop_i, cnt + 1, new_ds, warp,
                                           lane);
    else if (metric == kMetricCosine)
      score_rows<kMetricCosine, kElem, kWarps>(src, q_s, pq, rs, D, maxM,
                                               qq, lower, proc, n_proc,
                                               slot_id, pop_i, cnt + 1,
                                               new_ds, warp, lane);
    else
      score_rows<kMetricManhattan, kElem, kWarps>(
          src, q_s, pq, rs, D, maxM, qq, lower, proc, n_proc, slot_id, pop_i,
          cnt + 1, new_ds, warp, lane);
    __syncthreads();
    const int n_new = cnt[1];
    if (tid == 0) laps.lap(kLapRows);

    // the candidate queue after the pop: its incumbents from the new head
    const int rest = max(n_cand - T, 0);
    const int head2 = head + T == ring ? 0 : head + T;
    int n_cand2 = rest;
    if (n_new > 0) {
      // --- 4. rank the admitted by (d, slot)
      rank_admitted<kThreads>(new_ds, n_new, slot_id, srt_d, srt_i, tid);
      __syncthreads();
      if (tid == 0) laps.lap(kLapRank);
      // --- 5. each admitted entry's place in either queue (the incumbents
      // at or below it, before any moves)
      for (int e = tid; e < n_new; e += kThreads) {
        const float d = srt_d[e];
        at_r[e] = e + count_at_or_below(rd, n_res, d);
        at_c[e] = e + ring_count_at_or_below(cd, head2, ring, rest, d);
      }
      __syncthreads();
      if (tid == 0) laps.lap(kLapMerge);
      // the incumbents from the first admitted entry's place on move down
      // by the admitted strictly below them: tail first, a round reading
      // kChunk of each queue before a barrier and writing them after it
      const int from_r = at_r[0], from_c = at_c[0];
      for (int hi_r = n_res, hi_c = rest; hi_r > from_r || hi_c > from_c;
           hi_r = max(from_r, hi_r - kChunk),
               hi_c = max(from_c, hi_c - kChunk)) {   // uniform
        float vd_r[kMoveRun], vd_c[kMoveRun];
        int vi_r[kMoveRun], vi_c[kMoveRun], vo_r[kMoveRun], vo_c[kMoveRun];
#pragma unroll
        for (int u = 0; u < kMoveRun; ++u) {
          const int p = hi_r - 1 - (u * kThreads + tid);
          vo_r[u] = -1;
          if (p >= from_r) {
            vd_r[u] = rd[p];
            vi_r[u] = ri[p];
            vo_r[u] = p + count_below(srt_d, n_new, vd_r[u]);
          }
          const int x = hi_c - 1 - (u * kThreads + tid);
          vo_c[u] = -1;
          if (x >= from_c) {
            const int at = ring_at(head2, ring, x);
            vd_c[u] = cd[at];
            vi_c[u] = ci[at];
            vo_c[u] = x + count_below(srt_d, n_new, vd_c[u]);
          }
        }
        __syncthreads();
        // each incumbent lands, or, pushed past the width, leaves the
        // queue's held bit (read no more this step)
#pragma unroll
        for (int u = 0; u < kMoveRun; ++u) {
          if (vo_r[u] >= 0 && vo_r[u] < ef) {
            rd[vo_r[u]] = vd_r[u];
            ri[vo_r[u]] = vi_r[u];
          } else if (vo_r[u] >= ef && dense) {
            atomicAnd(held + (vi_r[u] >> 4),
                      ~(kInRes << (2 * (vi_r[u] & 15))));
          }
          if (vo_c[u] >= 0 && vo_c[u] < cap) {
            const int at = ring_at(head2, ring, vo_c[u]);
            cd[at] = vd_c[u];
            ci[at] = vi_c[u];
          } else if (vo_c[u] >= cap && dense) {
            atomicAnd(held + (vi_c[u] >> 4),
                      ~(kInCand << (2 * (vi_c[u] & 15))));
          }
        }
      }
      // the admitted land (every incumbent was read before the last
      // barrier; their places differ)
      for (int e = tid; e < n_new; e += kThreads) {
        if (at_r[e] < ef) {
          rd[at_r[e]] = srt_d[e];
          ri[at_r[e]] = srt_i[e];
        }
        if (at_c[e] < cap) {
          const int at = ring_at(head2, ring, at_c[e]);
          cd[at] = srt_d[e];
          ci[at] = srt_i[e];
        }
      }
      n_res = min(ef, n_res + n_new);
      n_cand2 = min(cap, rest + n_new);
      if (tid == 0) laps.lap(kLapMove);
      laps.barrier();
      // the admitted that landed set their held bits (each id's bits are
      // its own; words are shared, hence the atomics)
      for (int e = tid; dense && e < n_new; e += kThreads) {
        const int id = srt_i[e];
        const unsigned bits = (at_r[e] < ef ? kInRes : 0u) |
                              (at_c[e] < cap ? kInCand : 0u);
        if (bits) atomicOr(held + (id >> 4), bits << (2 * (id & 15)));
      }
    }
    // the next pop's places past the queue hold padding
    for (int x = n_cand2 + tid; x < T; x += kThreads) {
      const int at = ring_at(head2, ring, x);
      cd[at] = kInf;
      ci[at] = -1;
    }
    head = head2;
    n_cand = n_cand2;
    ++hops;
    evals += n_proc;
    __syncthreads();
    if (tid == 0) laps.lap(n_new > 0 ? kLapHeld : kLapMerge);
  }

  for (int p = tid; p < ef; p += kThreads) {
    out_d[(size_t)b * ef + p] = rd[p];
    out_i[(size_t)b * ef + p] = ri[p];
  }
  if (tid == 0) {
    out_hops[b] = hops;
    out_evals[b] = evals;
    laps.lap(kLapSetup);
    laps.flush(hops);
  }
}

// The launch's arguments, bundled for the dispatch over instances.
struct WalkArgs {
  const int* links;
  const int* counts;
  RowSource src;
  const float* queries;
  const float* entry_d;
  int* visited;
  int* wide_mem;
  int has_nodes, B, D, maxM, T, ef, cap, metric, vis_mode, vis_n;
  float* out_d;
  int* out_i;
  int* hops;
  int* evals;
};

template <int kElem, bool kDense, int kThreads>
cudaError_t launch(const WalkArgs& a, WalkLayout lay, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      beam_walk_kernel<kElem, kDense, kThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
  if (err != cudaSuccess) return err;
  beam_walk_kernel<kElem, kDense, kThreads><<<a.B, kThreads, lay.smem,
                                              stream>>>(
      a.links, a.counts, a.src, a.queries, a.entry_d, a.visited,
      a.has_nodes, a.D, a.maxM, a.T, a.ef, a.cap, a.metric, a.vis_mode,
      a.vis_n, lay.held_n, lay.slot_n, a.out_d, a.out_i, a.hops, a.evals);
  return cudaGetLastError();
}

// The wide instances' device memory a query, ``wide_words`` to the kernel:
// the walk's own words (a PQ table in device memory lies after all the
// queries' own words: WalkArgs::src.pq_tables).
template <int kElem>
cudaError_t launch_wide(const WalkArgs& a, WalkLayout lay,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      beam_walk_wide_kernel<kElem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
  if (err != cudaSuccess) return err;
  beam_walk_wide_kernel<kElem><<<a.B, kWideThreads, lay.smem, stream>>>(
      a.links, a.counts, a.src, a.queries, a.entry_d, a.visited, a.wide_mem,
      lay.words - lay.pq.words, lay.held_words, lay.queues_shared,
      a.has_nodes, a.D, a.maxM, a.T, a.ef, a.cap, lay.ring, a.metric,
      a.vis_mode, a.vis_n, lay.slot_n, a.out_d, a.out_i, a.hops, a.evals);
  return cudaGetLastError();
}

template <int kElem>
cudaError_t launch_elem(const WalkArgs& a, WalkLayout lay,
                        cudaStream_t stream) {
  // queues past kMaxQueue: one instance a row source, the visited set a
  // runtime branch (a rare, wide walk; a float32 ring has none: its
  // layout places no ring there)
  if constexpr (!is_ring(kElem))
    if (lay.ring) return launch_wide<kElem>(a, lay, stream);
  const bool wide = walk_threads(a.T, a.maxM) > 128;
  if (a.vis_mode == kVisDense)
    return wide ? launch<kElem, true, 256>(a, lay, stream)
                : launch<kElem, true, 128>(a, lay, stream);
  return wide ? launch<kElem, false, 256>(a, lay, stream)
              : launch<kElem, false, 128>(a, lay, stream);
}

// Blocks of ``kernel`` an SM holds at ``threads`` and ``smem`` bytes a block
// (the runtime's occupancy; -1 on an error).
template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// The occupancy of the instance launch_elem<kElem> takes.
template <int kElem>
int instance_blocks(int dense, int wide, int T, int maxM, size_t smem) {
  if (wide)
    return occupancy(beam_walk_wide_kernel<is_ring(kElem) ? kElemF32 : kElem>,
                     kWideThreads, smem);
  const bool w = walk_threads(T, maxM) > 128;
  if (dense)
    return w ? occupancy(beam_walk_kernel<kElem, true, 256>, 256, smem)
             : occupancy(beam_walk_kernel<kElem, true, 128>, 128, smem);
  return w ? occupancy(beam_walk_kernel<kElem, false, 256>, 256, smem)
           : occupancy(beam_walk_kernel<kElem, false, 128>, 128, smem);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// links i32[cap, maxM], counts i32[cap]; ``rows`` of element type ``elem``
// (0 float32, 1 int8, 2 bfloat16, 3 uint8 PQ codes): [cap, D] rows read at
// the neighbour's id (records = 0) or [cap, maxM, D] records read at the
// popped row's slot (records = 1; PQ: [cap, maxM, groups], records only);
// int8: ``scales`` f32[cap] or f32[cap, maxM] beside them; PQ:
// ``codebook`` f32[groups, 256, D / groups], whose distance table a block
// builds in shared memory, with the step's codes beside it where they fit,
// else in device memory (pq_place, counted in smem_bytes and wide_words);
// int8 / bf16 records or rows: each step's popped records, or its valid
// slots' rows, staged in shared memory where records_place can stage them
// (the alignment it checks includes the base of ``rows`` and, for records,
// of ``scales``) and smem_bytes count them (the caller's choice:
// ops/cuda_graph._records_place), else read from the records or rows;
// float32 records: a ring of the rows that smem_bytes count past the
// unstaged layout (whole rows of D floats, 16-byte ones, a 16-aligned
// base), else read from the records.
// queries f32[B, D] (the walk's query), entry_d f32[B] (read only when
// has_nodes).  visited_slots: -1 the dense dedupe (``visited`` unread), 0
// the bitmap (``visited`` i32[B, vis_n] words, vis_n >= cap / 32, zeroed
// but node 0's bit), 2^s >= 4 the hash set (``visited`` i32[B, 2^s], vis_n
// = 2^s, -1 but slot 0 = node 0); the kernel updates it; ``visited`` null:
// each block keeps its query's set in shared memory, filled so by the
// block (a table instance, where vis_place fits it and smem_bytes count
// it: ops/cuda_graph._visited_place).  ``wide_mem``
// i32[B, wide_words] (wide_words 0: unread): for a walk with ef or cap
// above 320, zeroed by the caller, the held bits of the dense dedupe over
// ``n_rows`` ids (the links' rows), then the queues where they do not fit
// in shared memory; then, after every query's words of those, a PQ table a
// query where it does not fit there.  All
// contiguous; T <= cap, ef and cap <= 2^20; smem_bytes and wide_words from
// ops/cuda_graph._walk_layout and _walk_wide_words.  Writes out_d f32[B,
// ef], out_i i32[B, ef], hops i32[B], evals i32[B].  Returns the launch's
// CUDA error (0 on success).
int beam_walk(const int* links, const int* counts, const void* rows,
              const float* scales, const float* codebook,
              const float* queries, const float* entry_d, int* visited,
              int* wide_mem, int elem, int records, int has_nodes, int B,
              int D, int maxM, int T, int ef, int cap, int metric, int groups,
              int visited_slots, int vis_n, int n_rows, int smem_bytes,
              int wide_words, float* out_d, int* out_i, int* hops,
              int* evals, void* stream_ptr) {
  if (B <= 0 || D <= 0 || maxM <= 0 || T <= 0 || ef <= 0 || cap <= 0 ||
      n_rows <= 0 || T > cap || ef > kMaxWideQueue || cap > kMaxWideQueue ||
      (metric != kMetricL2 && metric != kMetricCosine &&
       metric != kMetricManhattan))
    return (int)cudaErrorInvalidValue;
  if (elem < kElemF32 || elem > kElemPQ || (elem == kElemI8 && !scales) ||
      (elem == kElemPQ && (!records || !codebook || groups <= 0 ||
                           D % groups != 0)))
    return (int)cudaErrorInvalidValue;
  const int vis_mode = visited_slots < 0    ? kVisDense
                       : visited_slots == 0 ? kVisBitmap
                                            : kVisHash;
  if (vis_mode != kVisDense && vis_n <= 0) return (int)cudaErrorInvalidValue;
  if (vis_mode == kVisHash &&
      (visited_slots < 4 || (visited_slots & (visited_slots - 1)) ||
       vis_n != visited_slots))
    return (int)cudaErrorInvalidValue;
  // int8 / bf16 records or rows: staged where records_place can stage them
  // and the caller chose to (its smem_bytes count the staged rows); float32
  // records: a ring of as many rows as the bytes smem_bytes count past the
  // unstaged layout (at least one, whole rows); a visited set in shared
  // memory where the caller passes no ``visited`` (its smem_bytes count the
  // set: vis_place)
  const bool stage_src = elem == kElemI8 || elem == kElemBF16;
  const bool ring_src = elem == kElemF32 && records;
  const bool vis_shared = vis_mode != kVisDense && !visited;
  auto layout = [&](bool stage, int ring) {
    return walk_layout(
        ef, cap, T, maxM, D, n_rows, vis_mode == kVisDense,
        elem == kElemPQ ? groups : 0, metric,
        stage && stage_src ? (elem == kElemI8 ? 1 : 2) : ring ? 4 : 0,
        elem == kElemI8, !records,
        aligned(rows, 16) &&
            (elem != kElemI8 || !records || aligned(scales, 16)),
        vis_shared ? (size_t)vis_n : 0, ring);
  };
  WalkLayout lay = layout(true, 0);
  if (lay.rec.staged && lay.smem != (size_t)smem_bytes) lay = layout(false, 0);
  if (ring_src && (size_t)smem_bytes > lay.smem) {
    // the ring's rows, from the bytes past the unstaged layout (the ring is
    // 16-aligned whole rows, so a set after it moves by its bytes alone)
    const size_t ring = ((size_t)smem_bytes - lay.smem) / ((size_t)D * 4);
    if (ring >= 1 && ring <= (size_t)kSmemLimit) lay = layout(false, (int)ring);
  }
  if (lay.smem != (size_t)smem_bytes || lay.smem > (size_t)kSmemLimit ||
      lay.words != (size_t)wide_words || (lay.words && !wide_mem) ||
      lay.vis.shared != (int)vis_shared)
    return (int)cudaErrorInvalidValue;
  RowSource src{rows, scales, codebook, groups, groups > 0 ? D / groups : 0,
                records, 0, 0};
  src.round_pp = elem == kElemBF16 && !records && metric == kMetricCosine;
  if (elem == kElemF32)
    src.vec = D % 4 == 0 && aligned(rows, 16);
  else if (elem == kElemI8)
    src.vec = D % 4 == 0 && aligned(rows, 4);
  else if (elem == kElemBF16)
    src.vec = D % 4 == 0 && aligned(rows, 8);
  else
    src.vec = src.sub % 4 == 0 && aligned(codebook, 16);
  if (elem == kElemPQ) {
    src.pq_tables = lay.pq.words ? reinterpret_cast<float*>(
                                       wide_mem + (size_t)B * (lay.words -
                                                               lay.pq.words))
                                 : nullptr;
  }
  if (lay.rec.ring) src.ring = lay.rec.ring;
  const WalkArgs a{links,  counts, src,  queries, entry_d, visited, wide_mem,
                   has_nodes, B, D, maxM, T, ef, cap, metric, vis_mode,
                   vis_n,  out_d,  out_i, hops,   evals};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (elem) {
    case kElemF32:
      err = lay.rec.ring ? launch_elem<kElemF32Staged>(a, lay, stream)
                         : launch_elem<kElemF32>(a, lay, stream);
      break;
    case kElemI8:
      err = lay.rec.staged ? launch_elem<kElemI8Staged>(a, lay, stream)
                           : launch_elem<kElemI8>(a, lay, stream);
      break;
    case kElemBF16:
      err = lay.rec.staged ? launch_elem<kElemBF16Staged>(a, lay, stream)
                           : launch_elem<kElemBF16>(a, lay, stream);
      break;
    default:
      err = lay.pq.staged ? launch_elem<kElemPQ>(a, lay, stream)
                          : launch_elem<kElemPQFar>(a, lay, stream);
      break;
  }
  return (int)err;
}

// Blocks an SM holds at once of the walk instance that a launch of element
// type ``elem`` (0 float32, 1 int8, 2 bfloat16), its records or rows
// ``staged`` or not (float32: its records in a ring, table instances
// only), with the dense dedupe or a set, T and maxM takes, table or
// ``wide``, at smem_bytes a block: the runtime's occupancy of the built
// kernel.  -1 on an error.
int beam_walk_blocks(int elem, int staged, int dense, int wide, int T,
                     int maxM, int smem_bytes) {
  if (smem_bytes < 0 || smem_bytes > kSmemLimit) return -1;
  const size_t smem = (size_t)smem_bytes;
  switch (elem) {
    case kElemF32:
      return staged && !wide
                 ? instance_blocks<kElemF32Staged>(dense, wide, T, maxM, smem)
                 : instance_blocks<kElemF32>(dense, wide, T, maxM, smem);
    case kElemI8:
      return staged ? instance_blocks<kElemI8Staged>(dense, wide, T, maxM, smem)
                    : instance_blocks<kElemI8>(dense, wide, T, maxM, smem);
    case kElemBF16:
      return staged
                 ? instance_blocks<kElemBF16Staged>(dense, wide, T, maxM, smem)
                 : instance_blocks<kElemBF16>(dense, wide, T, maxM, smem);
    default: return -1;
  }
}

#ifdef PG_PROFILE
// Copies the instrumented build's counters (the laps' cycles, steps,
// blocks) to ``out`` and zeroes them.
int beam_walk_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_walk_prof,
                                         sizeof(g_walk_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kLaps + 2] = {};
  return (int)cudaMemcpyToSymbol(g_walk_prof, zero, sizeof(zero));
}
#endif

}  // extern "C"
