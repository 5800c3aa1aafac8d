// Fused exact k-NN sweep for NVIDIA Hopper (sm_90a): distance scores on the
// tensor cores and a running per-query top-k in one pass over the corpus,
// so the [B, N] distance matrix never reaches device memory.
//
// Replaces: pg_embedding_tpu/ops/pallas_bruteforce.py::_bruteforce_kernel
// (with _finalize_and_select and _insert_pass), the Pallas kernel behind
// pallas_exact_search.  It computes the same function, not the same blocks:
//   score  L2:     max(|p|^2 + |q|^2 - 2 q.p, 0)
//          cosine: 1 - q.p * rsqrt(max(|p|^2 |q|^2, 1e-30))
//   rows >= n_valid and tombstoned rows score +inf and are never admitted,
//   even into empty slots (an all-masked query returns ids -1, +inf);
//   results ascend by (score, id): equal scores keep the lower id, as the
//   TPU kernel's argmin + strict-< admission do;  L2 comes back sqrt'd.
// The corpus comes at its stored width, float32 or bfloat16 (as the Pallas
// kernel takes it), or as int8 rows with a float32 scale a row; queries are
// always float32.
//
// Precision.  One TF32 pass (10-bit mantissa) moves an L2 distance by up to
// ~1e-3 relative on clustered data and would reorder true neighbours.  The
// kernel splits each operand in registers into hi + lo, both TF32 values
// rounded as cvt.rna.tf32.f32 rounds, and issues lo.hi + hi.lo + hi.hi as
// TF32 mma.sync with float32 accumulation (CUTLASS's 3xTF32 "fast f32"):
// as exact as a float32 product, inside the Pallas kernel's ~2^-18 bar.  A
// bf16 row is exact in TF32 (p_lo = 0), so a bf16 corpus takes two passes,
// q_lo.p + q_hi.p.
//
// What bounds it on an H100 (1M x 128-d, B = 1024): 2 B N D = 262 GFLOP of
// products, times 3 passes = 786 GFLOP at 495 TFLOP/s dense TF32 = 1.59 ms
// (bf16 corpus, 2 passes: 1.06 ms).  The corpus is 512 MB (bf16: 256 MB),
// 0.15 ms at 3.35 TB/s, so the tensor cores bind, not device memory.
//
// Design, against what held the float32-FMA version back (CUDA-core
// scores, per-warp |p|^2, synchronous loads, a fixed query tile):
//  * Scores on the tensor cores.  mma.sync m16n8k8 .tf32: the queries'
//    row-major [B, D] layout is the "row" A operand and the corpus's
//    row-major [N, D] layout is the "col" B operand, so neither is
//    transposed.  With g = lane >> 2, t = lane & 3 a thread reads A at
//    (g, t), (g+8, t), (g, t+4), (g+8, t+4) and B at rows (n0+g), dims
//    (t, t+4); padded row strides (36 floats, 40 bf16) put the 32 lanes on
//    32 banks.  A block of 8 warps covers QT queries x 128 rows as 2 x 4
//    warps of 32 x 32 (QT = 64) or 1 x 8 of 16 x 16 (QT = 16).  Each thread
//    splits its own fragments, with two integer ops per half (cvt is a
//    multi-instruction conversion): a corpus value is split by 2 warps, not
//    by all 8, and a split copy in shared memory would cost as many
//    instructions as it saves.
//  * |p|^2 once per row per block: 2 threads per row sum the landed chunk in
//    float32 FMA.
//  * Asynchronous loads.  Corpus chunks [128 x 32] come through a 2-stage
//    ring of 16-byte cp.async.cg copies (zero-filled past the last row and
//    dim): chunk s+1 is in flight while chunk s feeds the mma's and, at a
//    tile's end, the selection.  The block's [QT x D] queries stay resident
//    in shared memory when they fit (queries are then read once per block,
//    not once per corpus tile: a third of the L2 traffic of a float32 sweep,
//    half of a bf16 one); else a [QT x 32] query chunk streams beside each
//    corpus chunk.  Rows that are not 16-byte multiples (float32 D % 4 != 0,
//    bf16 D % 8 != 0) or an unaligned base take a masked element path.
//  * A query tile sized by k_run.  The running lists take 8 QT k_run bytes
//    of shared memory: QT = 64 for k_run <= 256, 16 for <= 1024.  At small
//    k_run a QT = 64 block takes under half an SM's shared memory, so two
//    blocks share an SM and one block's selection and barriers overlap the
//    other's mma's (QT = 128 fills an SM alone and measured slower).
//    Python chooses QT, the corpus splits S and the resident queries
//    (ops/cuda_bruteforce._launch_shape) and passes its shared-memory
//    figure; the launch refuses a figure that differs from sweep_smem_bytes
//    or exceeds 232,448 bytes.  Blocks that share a split run side by side
//    (blockIdx.x is fastest), so the corpus comes from HBM about once.
//  * Selection: the accumulators become scores in a [QT x 128]
//    shared-memory tile; after one barrier warp w walks the scores of its
//    own QT / 8 queries in ascending row order, a ballot against the k-th
//    finds the rare candidates, and each is inserted into a sorted list of
//    k_run entries by a warp-parallel count and shift (the exact route's
//    short lists; the build's wide pools below).  Pass 2 merges the S
//    sorted partial lists of each query, applies sqrt for L2 and writes
//    [B, k_run].
//  * k_run past 1024 (the lists' shared memory) goes in pages: the caller
//    (ops/cuda_bruteforce.bruteforce_topk_paged) launches once per page of
//    at most 1024 with a per-query floor (score, id), the last entry of the
//    page before.  The selection admits only rows that follow the floor in
//    (score, id) order, and the merge writes the page's own last entry back
//    as the next floor (the score before the sqrt).  A row's score depends
//    on the query and the row alone (the same mma sequence in every tile
//    and launch shape), so the pages concatenate to the one long list.
// Not here yet: wgmma and TMA, a warp-specialised producer, a persistent
// grid, one launch for k_run > 1024.
//
// The int8-row instance (bruteforce_topk_q8) also replaces
// pg_embedding_tpu/core/build.py::_exact_candidates (its lax.fori_loop over
// chunks, approx_min_k and running merge; the exact rerank stays torch ops
// in the port): the build's candidate pool over the int8 shadow (exact8).
// A row element is bf16(bf16(q) * bf16(scale)), the JAX package's and the
// port's dequantisation: q is exact in bf16 and q * bf16(scale) exact in
// float32 (8 x 8 significant bits), so the element is that product rounded
// once to bf16, to nearest even, by integer ops (no fast-math, no fusion
// into the TF32 split).  A bf16 value is exact in TF32, so the instance
// takes the bf16 instance's two passes, q_lo.p + q_hi.p, and its accuracy.
// The ring lands int8 chunks [128 x 32] (48-byte rows: 16-byte copies when
// D % 16 == 0 and the base is aligned, else element loads) and, per stage,
// the tile's 128 scales (4-byte cp.async); each thread widens the elements
// it feeds to the mma's in registers.  What bounds it (1M x 128-d, one
// 256-row insert batch, k_run = 2 cand_cap = 256): the products, 2 B N D =
// 65.5 GFLOP, in the lesser of 2 TF32 passes at 495 TFLOP/s (0.265 ms) and
// 3 bf16 passes (the query split in three bf16 parts) at 989 TFLOP/s
// (0.199 ms); the shadow is 132 MB, 0.040 ms.
//
// The wide selection: lists of k_run <= kRegK = 256 in the int8 instance
// and in bruteforce_topk_wide / _bf16_wide, which the wrapper takes for
// k_run 64 to 256 (the build's pools, the exact route's k past 61; QT =
// 64).  At k_run = 256 a split of ~30,300 rows (33 splits of 1M) that
// starts from an empty list admits ~k (1 + ln(rows / k)) ~ 1,480 rows a
// query, where ~256 / 33 reach the merged pool; inserted one by one (a
// warp-wide dependent round each) they took ~5 of the sweep's 6.7 ms.
// Two changes cut that work:
//  * A bound shared across the splits.  The wrapper passes a scratch
//    f32[B, S] of +inf and a rank j = ceil(k_run / S), so S j >= k_run.
//    After each tile a split stores its list's j-th score in its slot
//    (query, split) when it fell; before each tile every warp reads its
//    queries' S slots and takes their largest, tau, and a row is admitted
//    only if its score <= tau (and, as before, < the list's own k-th).
//    Safe: the S slots name S j >= k_run live rows (each split's j best)
//    that score <= tau, so a row that scores > tau has k_run rows before
//    it and is not in the top k_run; a row that scores == tau may be, with
//    a lower id, so that test is <=, never <.  A slot only falls, so a
//    stale read gives a larger tau, which is still safe: no block waits
//    for another, the grid need not be co-resident, and the relaxed loads
//    and stores (device scope, served by L2) need no fence.  A split with
//    fewer than j live rows leaves +inf, which only turns the filter off.
//    Every row of the true top k_run is admitted by its split and never
//    evicted (k_run rows before it would have to exist), so the merged
//    pool is the true top k_run whatever the timing, and the partial
//    lists may end with +inf / -1 slots, which the merge sorts last.
//  * Whole-tile admission.  The list lives in registers while a query
//    takes a tile (8 entries a lane).  Up to kSerialMax admitted rows go
//    in one by one (insert_in_registers); more are merged 32 at a time
//    (merge_tile): staged in order through the query's spent score-tile
//    row, sorted across the warp by a bitonic network, and merged into
//    the list by FAISS's WarpSelect step (slot p takes the lesser of
//    itself and slot 255 - p of the group: the 256 least, bitonic) and a
//    bitonic merge of the 256.
// Both keep the (score, id) order: a tile's rows are admitted against the
// k-th the list had when the tile began, and a row that equals it follows
// it (rows arrive in ascending id), as the strict < of one by one.  The
// float32 / bf16 wide instances are new template instances beside the
// eight of the exact route, whose code is unchanged; lists of 257-1024
// entries (QT = 16) keep the insertion into shared memory.  Left for
// later: wgmma, a bf16 x 3 query split on the bf16 tensor cores (the
// int8 rows are bf16 values).
//
// The Manhattan instances (bruteforce_topk_l1, _bf16_l1, _q8_l1) replace
// the JAX package's Manhattan sweeps: pg_embedding_tpu/ops/bruteforce.py's
// chunk loop (exact_search, reached from pallas_exact_search for
// Manhattan) and core/build.py::_exact_candidates under Manhattan (the
// same fori_loop as L2's).  Manhattan has no matmul form: the CUDA cores
// sum |q - p| over the ring's staged row chunk, dims ascending, one
// accumulator a (query, row), each difference and sum rounded on its own;
// an int8 row element is the L2 path's, widen(p, bf16(scale)).  No |p|^2,
// no split passes; the sums are the score.  They are compile-time
// instances (kL1) beside the exact route's eight, whose code is
// unchanged, and take the int8 instance's selection at every k_run: the
// wide one with the shared bound up to 256, the insertion into shared
// memory past it, pages past 1024.
// What bounds them: 2 B N D float32 operations (a subtraction and an
// |.|-addition a term), 3.91 ms at 1M x 128-d, B = 1024, at the published
// 67 TFLOP/s.  That rate counts an FMA as two operations; a subtraction
// and an addition are two FADD instructions that cannot fuse, so no
// kernel of this arithmetic passes half of that bound: the reachable floor
// is 2 B N D FADDs at 132 SMs x 128 lanes x the SM clock, 7.83 ms at 1.98
// GHz (the build's 256-row batch: 1.96 ms).
// A warp scheduler issues one instruction a cycle and a warp's FADD takes
// that cycle, so every other instruction in the inner loop (loads,
// conversions, address arithmetic) costs FADD issue.  The design:
//  * Each staged element widened once.  When a ring stage lands, the
//    block writes its [128 x 32] row chunk as float32 into one [128 x 36]
//    buffer (16 elements a thread: int8 rows times their round_bf16 scale,
//    bf16 rows shifted), then one barrier; float32 rows are read from the
//    ring as they land.  All three instances share one inner loop.
//  * A register tile shaped for FADD, not the mma fragment (l1_tile): a
//    thread sums RQ queries x RN rows (4 x 8 at QT = 64, 2 x 4 at QT =
//    16), query qg + QG i and row rg + RG j, the eight lanes of a quarter
//    warp on one query (a broadcast) and eight consecutive rows (144-byte
//    strides: eight bank quads).  A 4-dim step reads each operand as one
//    16-byte load: RQ + RN LDS.128 against 8 RQ RN FADDs (12 against 256
//    at QT = 64), where the mma fragment's layout took 12 scalar loads and
//    8 widenings against 64.
//  * The queries' dim pairs swapped as they land (swap_dim_pairs; resident
//    queries once a block): a 16-byte load fills four consecutive
//    registers, so a query's dim and a row's would share a register bank
//    and every subtraction would wait on it.
//  * The sums go to the score tile at (query, row), where the selection
//    reads them; the selection, the pages and the merge are the int8
//    instance's.
// What it leaves (sweep_probe's l1-* variants): the selection, the ring's
// copies not hidden at QT = 64, and, for the int8 instance at the
// build's pool (232,192 bytes), one block an SM.
// The compressed sweep's PQ pool has its own kernel (csrc/pq_topk.cu).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                 // corpus rows per tile
constexpr int kRowsPerLane = kTileN / 32;
constexpr int kTileD = 32;                  // dims per ring chunk
constexpr int kStages = 2;
constexpr int kQStride = kTileD + 4;        // query chunk row stride (floats)
constexpr int kSStride = kTileN + 8;        // score tile row stride (floats)
constexpr int kWStride = kTileD + 4;        // widened chunk stride (floats)
constexpr int kMaxSplits = 128;
constexpr int kMaxK = 1024;
constexpr int kSmemLimit = 232448;
constexpr int kMergeWarps = 4;
// the wide selection (the build's pools): lists up to kRegK entries take
// a tile in registers, kRegE entries a lane
constexpr int kRegE = 8;
constexpr int kRegK = 32 * kRegE;
// a query's rows admitted from one tile go in one by one up to this many,
// else sorted and merged 32 at a time (sweep_probe's bound-serial,
// bound-merge and serial-max-N: either path alone is slower; 8 is as fast
// as 12 and beats 1, 2, 4, 16 and 32 at the build's pools and k_run 102)
constexpr int kSerialMax = 8;
// whether a split reads the bound the splits publish (sweep_probe's
// no-shared-bound and serial-select variants turn it off)
constexpr bool kReadBound = true;
constexpr int kMetricL2 = 0;
constexpr int kMetricCosine = 1;
constexpr int kMetricManhattan = 2;           // the kL1 instances' only
constexpr unsigned kFull = 0xffffffffu;

// corpus chunk row stride in elements: 32 dims + 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int p_stride() {
  return kTileD + 16 / (int)sizeof(T);
}

// Warp layout of a QT x 128 block tile: WM x WN warps, each with MT m16
// tiles of queries and NT n8 tiles of rows.
template <int QT>
struct Layout {
  static constexpr int WM = QT >= 64 ? 2 : 1;
  static constexpr int WN = kWarps / WM;
  static constexpr int MT = QT / WM / 16;
  static constexpr int NT = kTileN / WN / 8;
  static constexpr int QPW = QT / kWarps;       // queries each warp selects
};

// Row stride (floats) of a block's resident query tile: D padded to whole
// chunks, plus 4 (conflict-free fragment reads, 16-byte rows).
__host__ __device__ inline int q_res_stride(int D) {
  return kTileD * ((D + kTileD - 1) / kTileD) + 4;
}

// int8 rows carry a float32 scale a row
template <typename T>
__host__ __device__ constexpr bool scaled_rows() {
  return std::is_same<T, int8_t>::value;
}

// a ring stage's bytes beside the corpus chunk: int8 rows' scales
template <typename T>
__host__ __device__ constexpr int stage_extra_bytes() {
  return scaled_rows<T>() ? kTileN * 4 : 0;
}

// The Manhattan instances' widened row chunk (bf16 and int8 rows): [128 x
// kWStride] float32, read as the ring's float32 chunks are (row stride 36)
template <typename T, bool kL1>
__host__ __device__ constexpr int widened_bytes() {
  return kL1 && !std::is_same<T, float>::value ? kTileN * kWStride * 4 : 0;
}

// Shared memory: the ring (each stage a [128 x kPS] corpus chunk, for int8
// rows the tile's 128 scales, then, when queries stream, a [QT x 36]
// query chunk), the Manhattan instances' widened chunk (bf16 and int8
// rows), the
// resident [QT x q_res_stride(D)] queries when they do not, the
// [QT x 136] score tile, |q|^2, |p|^2, and the [QT x k_run] running lists
// (score, id).
template <typename T, bool kL1>
size_t sweep_smem_bytes(int qt, int k_run, int D, bool q_res) {
  const size_t stage = (size_t)kTileN * p_stride<T>() * sizeof(T) +
                       stage_extra_bytes<T>() +
                       (q_res ? 0 : (size_t)qt * kQStride * sizeof(float));
  return kStages * stage + widened_bytes<T, kL1>() +
         sizeof(float) * ((q_res ? (size_t)qt * q_res_stride(D) : 0) +
                          (size_t)qt * kSStride + qt + kTileN) +
         (sizeof(float) + sizeof(int)) * (size_t)qt * k_run;
}

// (d, id) order; id -1 (an empty slot) sorts after every real id
__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && (unsigned)ia < (unsigned)ib);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A bf16 value is the high half of its float32: the widening is exact.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t bits) {
  return __uint_as_float((unsigned)bits << 16);
}

// float32 -> bf16 -> float32, to nearest even (as __float2bfloat16_rn and
// torch round a finite value): add 0x7fff plus the kept half's lowest bit,
// clear the low 16 bits.
__device__ __forceinline__ float round_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// An int8 row element: bf16(bf16(q) * s_bf16), s_bf16 the row's scale
// rounded by round_bf16.  The float32 product is exact, so one rounding.
__device__ __forceinline__ float widen(int8_t q, float s_bf16) {
  return round_bf16(__fmul_rn((float)q, s_bf16));
}

// The split x = hi + lo with hi, lo TF32 values rounded as
// cvt.rna.tf32.f32 rounds (to nearest, ties away from zero): adding half a
// TF32 ulp (0x1000) to the float32 bits and clearing the 13 bits below the
// 10-bit mantissa.  The mma reads only the top 19 bits of an operand, so
// lo needs no clearing.  Two integer ops, where cvt.rna.tf32.f32 compiles
// to a longer sequence (sweep_probe.py's cvt-rounding variant is slower).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a.b, m16n8k8, TF32 inputs, float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

// 4-byte global -> shared copy; zero-filled when !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) x dims [d0, d0 + 32) of a row-major [*, D]
// matrix into dst (row stride S elements), zero past row_end and D.  With
// ``vec`` (16-byte rows, aligned base) a 16-byte segment lies wholly inside
// or outside D and goes by cp.async; else element by element.
template <int ROWS, typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, T* dst,
                                           int S, int row0, int row_end,
                                           int d0, int D, bool vec, int tid) {
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kSegs = kTileD / kVec;
    for (int e = tid; e < ROWS * kSegs; e += kThreads) {
      const int r = e / kSegs, c = (e % kSegs) * kVec;
      const int row = row0 + r, col = d0 + c;
      const bool in = row < row_end && col < D;
      cp_async16(dst + r * S + c, in ? src + (size_t)row * D + col : src, in);
    }
  } else {
    for (int e = tid; e < ROWS * kTileD; e += kThreads) {
      const int r = e / kTileD, c = e % kTileD;
      const int row = row0 + r, col = d0 + c;
      dst[r * S + c] =
          (row < row_end && col < D) ? src[(size_t)row * D + col] : T(0);
    }
  }
}

// Issue the copies of the step at (tile, d0) into ring stage s & 1 (see
// sweep_kernel); the tile's scales (zero past row_end) for int8 rows, the
// query chunk only when queries stream.
template <int QT, bool kQRes, int kPBytes, int kStageBytes, typename T>
__device__ __forceinline__ void load_step(const float* __restrict__ q,
                                          const T* __restrict__ p,
                                          unsigned char* smem, int s, int tile,
                                          int d0, int row_end, int q0, int B,
                                          int D, bool vec_q, bool vec_p,
                                          int tid,
                                          const float* __restrict__ scale) {
  constexpr int kExtraBytes = stage_extra_bytes<T>();
  unsigned char* stage = smem + (s & 1) * kStageBytes;
  load_chunk<kTileN>(p, reinterpret_cast<T*>(stage), p_stride<T>(), tile,
                     row_end, d0, D, vec_p, tid);
  if constexpr (scaled_rows<T>()) {
    if (tid < kTileN) {
      const bool in = tile + tid < row_end;
      cp_async4(reinterpret_cast<float*>(stage + kPBytes) + tid,
                in ? scale + tile + tid : scale, in);
    }
  }
  if (!kQRes)
    load_chunk<QT>(q, reinterpret_cast<float*>(stage + kPBytes + kExtraBytes),
                   kQStride, q0, B, d0, D, vec_q, tid);
}

// The score-tile row and the current k-th of local query ql: lane l reads
// rows l, l + 32, l + 64, l + 96.
__device__ __forceinline__ void read_query(const float* score_s,
                                           const float* list_d, int ql,
                                           int k_run, int lane,
                                           float (&sc)[kRowsPerLane],
                                           float& kth) {
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j)
    sc[j] = score_s[ql * kSStride + lane + 32 * j];
  kth = list_d[ql * k_run + k_run - 1];
}

// Relaxed loads and stores of the shared bound at device scope: served by
// L2 (no stale L1 line), and volatile, so no tile's read is hoisted.
__device__ __forceinline__ float load_bound(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_bound(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;\n" ::"l"(p), "f"(v)
               : "memory");
}

// The bound of each of a warp's QPW queries (the first q_first): the
// largest of the S splits' slots (bound f32[B, S]).  Lane l folds query
// l % QPW's slots l / QPW, + 32 / QPW, ...; lane i < QPW returns query i's.
template <int QPW>
__device__ __forceinline__ float read_bound(const float* bound, int q_first,
                                            int B, int S, int lane) {
  const int qi = q_first + lane % QPW;
  float t = -CUDART_INF_F;
  if (qi < B) {
#pragma unroll 4
    for (int s = lane / QPW; s < S; s += 32 / QPW)
      t = fmaxf(t, load_bound(bound + (size_t)qi * S + s));
  }
#pragma unroll
  for (int o = QPW; o < 32; o <<= 1)
    t = fmaxf(t, __shfl_xor_sync(kFull, t, o));
  return t;
}

// Entry e of a lane's kRegE (e runtime, the registers indexed statically)
__device__ __forceinline__ float pick(const float (&r)[kRegE], int e) {
  float v = r[0];
#pragma unroll
  for (int x = 1; x < kRegE; ++x)
    if (x == e) v = r[x];
  return v;
}

// Insert the rows of a tile that ``admit`` names (bit l of admit[j]: row
// tile + l + 32 j, score sc[j] of lane l) into one query's sorted register
// list (rd, ri) of k_run <= kRegK entries, one by one: an insertion is
// kRegE compares, a warp sum, two shuffles and a shift inside each lane,
// where the list in shared memory takes k_run / 32 reads to place an entry
// and as many rounds of reads, writes and barriers to shift the rest.  A
// new row goes after every entry of its score (rows arrive in ascending id
// order), and is skipped once the k-th has fallen to it.
__device__ __forceinline__ void insert_in_registers(
    float (&rd)[kRegE], int (&ri)[kRegE], const float (&sc)[kRowsPerLane],
    const unsigned (&admit)[kRowsPerLane], float kth, int tile, int k_run,
    int lane) {
  const int last_lane = (k_run - 1) / kRegE, last_e = (k_run - 1) % kRegE;
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    unsigned mask = admit[j];
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float dv = __shfl_sync(kFull, sc[j], src);
      if (!(dv < kth)) continue;                         // warp-uniform
      int below = 0;
#pragma unroll
      for (int e = 0; e < kRegE; ++e) below += rd[e] <= dv;
      const int pos = __reduce_add_sync(kFull, below);
      const int iv = tile + src + 32 * j;
      // entries past pos move up one: a lane's first takes the last of
      // the lane below
      const float up_d = __shfl_up_sync(kFull, rd[kRegE - 1], 1);
      const int up_i = __shfl_up_sync(kFull, ri[kRegE - 1], 1);
#pragma unroll
      for (int e = kRegE - 1; e > 0; --e) {
        const int idx = kRegE * lane + e;
        if (idx > pos) {
          rd[e] = rd[e - 1];
          ri[e] = ri[e - 1];
        } else if (idx == pos) {
          rd[e] = dv;
          ri[e] = iv;
        }
      }
      if (kRegE * lane > pos) {
        rd[0] = up_d;
        ri[0] = up_i;
      } else if (kRegE * lane == pos) {
        rd[0] = dv;
        ri[0] = iv;
      }
      kth = __shfl_sync(kFull, pick(rd, last_e), last_lane);
    }
  }
}

// (d, id) of the lane and of lane ^ o in a compare-exchange: keep the
// lesser where ``keep_less``, else the greater
__device__ __forceinline__ void exchange(float& d, int& id, int o,
                                         bool keep_less) {
  const float od = __shfl_xor_sync(kFull, d, o);
  const int oi = __shfl_xor_sync(kFull, id, o);
  if (keep_less ? lex_less(od, oi, d, id) : lex_less(d, id, od, oi)) {
    d = od;
    id = oi;
  }
}

// Merge the ``admitted`` rows of a tile that ``admit`` names into one
// query's register list (rd, ri) of kRegK slots, 32 rows at a time.  A
// group is staged in admission order through ``stage`` (64 words of the
// query's spent score-tile row), so lane r takes its r-th row; a bitonic
// network sorts the group across the lanes by (score, id); slot p of the
// list takes the lesser of itself and slot kRegK - 1 - p of the group
// padded to kRegK (the kRegK least of both, in a bitonic order), and a
// bitonic merge sorts the slots again: 8 stages of compare-exchanges over
// a lane's 8 slots, where one-by-one insertion takes a dependent warp
// round a row.
__device__ __forceinline__ void merge_tile(
    float (&rd)[kRegE], int (&ri)[kRegE], const float (&sc)[kRowsPerLane],
    const unsigned (&admit)[kRowsPerLane], int admitted, int tile, int lane,
    float* stage) {
  int* stage_c = reinterpret_cast<int*>(stage + 32);
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int g = 0; g < admitted; g += 32) {
    int rank = -g;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int r = rank + __popc(admit[j] & lanes_below);
      if (((admit[j] >> lane) & 1u) && r >= 0 && r < 32) {
        stage[r] = sc[j];
        stage_c[r] = lane + 32 * j;
      }
      rank += __popc(admit[j]);
    }
    __syncwarp();
    float d = CUDART_INF_F;
    int id = -1;
    if (lane < admitted - g) {
      d = stage[lane];
      id = tile + stage_c[lane];
    }
    __syncwarp();
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
      for (int o = k >> 1; o > 0; o >>= 1)
        exchange(d, id, o, ((lane & o) == 0) == ((lane & k) == 0));
    // slot p meets slot kRegK - 1 - p of the group: lanes 28-31 only
#pragma unroll
    for (int e = 0; e < kRegE; ++e) {
      const int src = kRegK - 1 - kRegE * lane - e;
      const float od = __shfl_sync(kFull, d, src & 31);
      const int oi = __shfl_sync(kFull, id, src & 31);
      if (src < 32 && lex_less(od, oi, rd[e], ri[e])) {
        rd[e] = od;
        ri[e] = oi;
      }
    }
    // slots 128, 64, 32, 16, 8 apart: across lanes; 4, 2, 1: in a lane
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int e = 0; e < kRegE; ++e)
        exchange(rd[e], ri[e], o, (lane & o) == 0);
#pragma unroll
    for (int o = kRegE / 2; o > 0; o >>= 1)
#pragma unroll
      for (int e = 0; e < kRegE; ++e)
        if ((e & o) == 0 && lex_less(rd[e | o], ri[e | o], rd[e], ri[e])) {
          const float td = rd[e];
          const int ti = ri[e];
          rd[e] = rd[e | o];
          ri[e] = ri[e | o];
          rd[e | o] = td;
          ri[e | o] = ti;
        }
  }
}

// One query's selection over a tile in the wide instances: its list (ld,
// li) of k_run <= kRegK entries into registers (lane l: entries [kRegE l,
// kRegE l + kRegE), +inf / -1 past k_run); the tile's rows that score
// under ``kth`` (sc: lane l's rows l + 32 j, masked rows +inf) go in one by
// one or merged as a tile; then, when its j-th (``bound_rank``) fell, the
// split's slot ``at`` of ``bound`` takes it; the list goes back.
__device__ __forceinline__ void select_in_registers(
    float* ld, int* li, const float (&sc)[kRowsPerLane], float kth, int tile,
    int k_run, int lane, float* stage, float* bound, int at,
    int bound_rank) {
  float rd[kRegE];
  int ri[kRegE];
#pragma unroll
  for (int e = 0; e < kRegE; ++e) {
    const int idx = kRegE * lane + e;
    rd[e] = idx < k_run ? ld[idx] : CUDART_INF_F;
    ri[e] = idx < k_run ? li[idx] : -1;
  }
  const int jr = max(bound_rank, 1) - 1;
  const float jth = pick(rd, jr % kRegE);
  unsigned admit[kRowsPerLane];
  int admitted = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    admit[j] = __ballot_sync(kFull, sc[j] < kth);
    admitted += __popc(admit[j]);
  }
  if (admitted <= kSerialMax)
    insert_in_registers(rd, ri, sc, admit, kth, tile, k_run, lane);
  else
    merge_tile(rd, ri, sc, admit, admitted, tile, lane, stage);
  if (bound != nullptr && lane == jr / kRegE) {
    const float now = pick(rd, jr % kRegE);
    if (now < jth) store_bound(bound + at, now);
  }
#pragma unroll
  for (int e = 0; e < kRegE; ++e) {
    const int idx = kRegE * lane + e;
    if (idx < k_run) {
      ld[idx] = rd[e];
      li[idx] = ri[e];
    }
  }
  __syncwarp();
}

// Manhattan's register tile (the kL1 instances) of a QT x 128 block tile:
// RG row groups x QG query groups, one a thread; thread (qg, rg) sums the
// queries qg + QG i (i < RQ) against the rows rg + RG j (j < RN).  Lane l
// of warp w has rg = l % 8 + 8 (w % (RG / 8)) and qg = l / 8 + 4 (w / (RG /
// 8)): a quarter warp's eight lanes read one query (a broadcast) and eight
// consecutive rows, 144 bytes apart (eight bank quads), and a warp writes
// its 32 scores of a (i, j) to 32 banks.
template <int QT>
struct L1Tile {
  static constexpr int RG = QT >= 64 ? 16 : 32;
  static constexpr int QG = kThreads / RG;
  static constexpr int RQ = QT / QG;
  static constexpr int RN = kTileN / RG;
  static_assert(QG * RQ == QT && RG * RN == kTileN && RG % 8 == 0 &&
                    QG == 4 * kWarps / (RG / 8),
                "a quarter warp's lanes take one query and 8 rows");
  static_assert(p_stride<float>() == kWStride,
                "float32 rows are read from the ring as widened ones");
};

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Each pair of dims of ``rows`` x ``cols`` floats (row stride ``stride``,
// both even) swapped in place: Manhattan's queries as l1_tile reads them.
// A 16-byte load fills four consecutive registers, so a query's dim and a
// row's same dim would sit in registers of the same parity, one register
// bank: every subtraction would wait a cycle on the bank.  With the
// query's pairs swapped, dim d of the query is in component d ^ 1.
__device__ __forceinline__ void swap_dim_pairs(float* x, int stride,
                                               int rows, int cols, int tid) {
  const int pairs = cols / 2;
  for (int e = tid; e < rows * pairs; e += kThreads) {
    float2* v = reinterpret_cast<float2*>(x + (e / pairs) * stride +
                                          2 * (e % pairs));
    const float2 w = *v;
    *v = make_float2(w.y, w.x);
  }
}

// The operands of four dims from k0 of a thread's register tile: its
// queries from q_s (row stride qs floats, its first query at row 0), its
// float32 rows from p_f (row stride kWStride, its first row at row 0),
// each one 16-byte load.
template <int QT>
__device__ __forceinline__ void l1_load(const float* q_s, int qs,
                                        const float* p_f, int k0,
                                        float4 (&qv)[L1Tile<QT>::RQ],
                                        float4 (&pv)[L1Tile<QT>::RN]) {
  using L = L1Tile<QT>;
#pragma unroll
  for (int i = 0; i < L::RQ; ++i)
    qv[i] = *reinterpret_cast<const float4*>(q_s + i * L::QG * qs + k0);
#pragma unroll
  for (int j = 0; j < L::RN; ++j)
    pv[j] = *reinterpret_cast<const float4*>(p_f + j * L::RG * kWStride + k0);
}

// Four dims of |q - p| into the tile's sums, dims ascending, every
// difference and sum rounded on its own (the query's dim d in component
// d ^ 1: swap_dim_pairs).
template <int QT>
__device__ __forceinline__ void l1_step(
    const float4 (&qv)[L1Tile<QT>::RQ], const float4 (&pv)[L1Tile<QT>::RN],
    float (&acc)[L1Tile<QT>::RQ][L1Tile<QT>::RN]) {
  using L = L1Tile<QT>;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RN; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], fabsf(__fsub_rn(part(qv[i], c ^ 1),
                                                         part(pv[j], c))));
}

// One ring step's 32 dims of Manhattan into the tile's sums ``acc``
// (queries and rows as l1_load reads them), four dims at a time.
template <int QT>
__device__ __forceinline__ void l1_tile(
    const float* q_s, int qs, const float* p_f,
    float (&acc)[L1Tile<QT>::RQ][L1Tile<QT>::RN]) {
  float4 qv[L1Tile<QT>::RQ], pv[L1Tile<QT>::RN];
#pragma unroll 1
  for (int k0 = 0; k0 < kTileD; k0 += 4) {
    l1_load<QT>(q_s, qs, p_f, k0, qv, pv);
    l1_step<QT>(qv, pv, acc);
  }
}

// The landed row chunk of a Manhattan instance over bf16 or int8 rows as
// float32 into p_f ([128 x kWStride]): thread t widens row t / 2, dims
// 16 (t % 2) to + 16, from one or two 16-byte reads to four 16-byte
// writes; an int8 element is widen(p, round_bf16(scale)), a bf16 one its
// high half.
template <typename T>
__device__ __forceinline__ void widen_chunk(const T* p_s,
                                            const float* scale_s, float* p_f,
                                            int tid) {
  constexpr int kPS = p_stride<T>();
  const int r = tid >> 1, c0 = (tid & 1) * (kTileD / 2);
  float4* dst = reinterpret_cast<float4*>(p_f + r * kWStride + c0);
  if constexpr (scaled_rows<T>()) {
    const float sr = round_bf16(scale_s[r]);
    const int4 raw = *reinterpret_cast<const int4*>(p_s + r * kPS + c0);
    const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int v = 0; v < 4; ++v)
      dst[v] = make_float4(widen((int8_t)(w[v]), sr),
                           widen((int8_t)(w[v] >> 8), sr),
                           widen((int8_t)(w[v] >> 16), sr),
                           widen((int8_t)(w[v] >> 24), sr));
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(p_s + r * kPS + c0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 raw = src[h];
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int v = 0; v < 2; ++v)
        dst[2 * h + v] = make_float4(
            __uint_as_float(w[2 * v] << 16),
            __uint_as_float(w[2 * v] & 0xffff0000u),
            __uint_as_float(w[2 * v + 1] << 16),
            __uint_as_float(w[2 * v + 1] & 0xffff0000u));
    }
  }
}

__device__ __forceinline__ float score(float dot, float pn, float qn,
                                       int metric) {
  return metric == kMetricL2 ? fmaxf(pn + qn - 2.f * dot, 0.f)
                             : 1.f - dot * rsqrtf(fmaxf(pn * qn, 1e-30f));
}

// One block's sweep: queries [blockIdx.x QT, + QT) against split
// blockIdx.y's rows, the running lists written to part_d / part_i.
// ``scale``: the int8 rows' scales (null for float32 and bf16 rows).
// ``kWide``: lists of up to kRegK entries take the wide selection, with
// the bound f32[B, S] shared across splits at rank ``bound_rank`` (none
// when null).  ``kL1``: Manhattan, summed on the CUDA cores (l1_tile).
template <int QT, bool kQRes, bool kWide, typename T, bool kL1 = false>
__device__ __forceinline__ void sweep_block(
    const float* __restrict__ q, const T* __restrict__ p,
    const float* __restrict__ scale, const unsigned char* __restrict__ del,
    int B, int n_rows, int D, bool vec_q, bool vec_p, int k_run, int metric,
    int rows_per_split, const float* __restrict__ floor_d,
    const int* __restrict__ floor_i, float* __restrict__ part_d,
    int* __restrict__ part_i, float* bound, int bound_rank) {
  using L = Layout<QT>;
  constexpr int kPS = p_stride<T>();
  constexpr int kPBytes = kTileN * kPS * (int)sizeof(T);
  // bf16 rows and int8 x scale elements are bf16 values: exact in TF32
  constexpr bool kExactRows = !std::is_same<T, float>::value;
  constexpr bool kScaled = scaled_rows<T>();
  constexpr int kExtraBytes = stage_extra_bytes<T>();
  constexpr int kStageBytes = kPBytes + kExtraBytes +
                              (kQRes ? 0 : QT * kQStride * (int)sizeof(float));
  const int q_all_stride = q_res_stride(D);
  // Manhattan over bf16 / int8 rows widens each landed chunk once
  constexpr bool kWiden = widened_bytes<T, kL1>() > 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* p_wide = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* q_all = reinterpret_cast<float*>(smem + kStages * kStageBytes +
                                          widened_bytes<T, kL1>());
  float* score_s = q_all + (kQRes ? QT * q_all_stride : 0);
  float* qn_s = score_s + QT * kSStride;                // [QT]
  float* pn_s = qn_s + QT;                              // [kTileN]
  float* list_d = pn_s + kTileN;                        // [QT][k_run]
  int* list_i = reinterpret_cast<int*>(list_d + QT * k_run);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m_base = (warp / L::WN) * (QT / L::WM);
  const int n_base = (warp % L::WN) * (kTileN / L::WN);
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_rows, row_begin + rows_per_split);

  for (int e = tid; e < QT * k_run; e += kThreads) {
    list_d[e] = CUDART_INF_F;
    list_i[e] = -1;
  }
  for (int i = 0; i < (kL1 ? 0 : L::QPW); ++i) {         // |q|^2
    const int qi = q0 + warp * L::QPW + i;
    float s = 0.f;
    if (qi < B)
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)qi * D + d];
        s = fmaf(v, v, s);
      }
    s = warp_sum(s);
    if (lane == 0) qn_s[warp * L::QPW + i] = s;
  }
  __syncthreads();

  // step s of the sweep is (tile s / n_chunks, dim chunk s % n_chunks), in
  // ring stage s & 1; the loop carries both for step s and step s + 1
  const int n_chunks = (D + kTileD - 1) / kTileD;
  const int n_tiles =
      row_end > row_begin ? (row_end - row_begin + kTileN - 1) / kTileN : 0;
  const int total = n_tiles * n_chunks;

  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  // Manhattan's sums and the thread's query and row groups (L1Tile)
  using T1 = L1Tile<QT>;
  float l1_acc[T1::RQ][T1::RN];
#pragma unroll
  for (int i = 0; i < T1::RQ; ++i)
#pragma unroll
    for (int j = 0; j < T1::RN; ++j) l1_acc[i][j] = 0.f;
  const int l1_rg = (lane & 7) + 8 * (warp % (T1::RG / 8));
  const int l1_qg = (lane >> 3) + 4 * (warp / (T1::RG / 8));
  float pn_part = 0.f;              // |p|^2 of row tid/2, half tid%2

  if (total > 0) {
    if (kQRes)                  // the whole query tile, once, with step 0
      for (int c = 0; c < n_chunks; ++c)
        load_chunk<QT>(q, q_all + c * kTileD, q_all_stride, q0, B,
                       c * kTileD, D, vec_q, tid);
    load_step<QT, kQRes, kPBytes, kStageBytes>(q, p, smem, 0, row_begin, 0,
                                               row_end, q0, B, D, vec_q, vec_p,
                                               tid, scale);
  }
  cp_async_commit();
  int tile = row_begin, chunk = 0;                      // step s
  for (int s = 0; s < total; ++s) {
    const bool last = chunk == n_chunks - 1;
    // stage (s+1)&1 was last read in step s-1, before its closing barrier
    if (s + 1 < total)
      load_step<QT, kQRes, kPBytes, kStageBytes>(
          q, p, smem, s + 1, last ? tile + kTileN : tile,
          last ? 0 : (chunk + 1) * kTileD, row_end, q0, B, D, vec_q, vec_p,
          tid, scale);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* p_s = reinterpret_cast<const T*>(smem + (s & 1) * kStageBytes);
    const float* scale_s =
        reinterpret_cast<const float*>(smem + (s & 1) * kStageBytes + kPBytes);
    const float* q_s =
        kQRes ? q_all + chunk * kTileD
              : reinterpret_cast<const float*>(smem + (s & 1) * kStageBytes +
                                               kPBytes + kExtraBytes);
    const int qs = kQRes ? q_all_stride : kQStride;
    if constexpr (!kL1) {
      const T* pr = p_s + (tid >> 1) * kPS + (tid & 1) * (kTileD / 2);
      if constexpr (kScaled) {
        const float sr = round_bf16(scale_s[tid >> 1]);
#pragma unroll
        for (int c = 0; c < kTileD / 2; ++c) {
          const float v = widen(pr[c], sr);
          pn_part = fmaf(v, v, pn_part);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kTileD / 2; ++c) {
          const float v = widen(pr[c]);
          pn_part = fmaf(v, v, pn_part);
        }
      }
    }

    if constexpr (kL1) {
      // Manhattan has no matmul form: the CUDA cores sum it, over rows
      // widened once (float32 rows as they landed) and queries whose dim
      // pairs are swapped as they land (resident: once, at step 0)
      const float* p_f = reinterpret_cast<const float*>(p_s);
      if (!kQRes || s == 0) {
        swap_dim_pairs(const_cast<float*>(kQRes ? q_all : q_s),
                       kQRes ? q_all_stride : kQStride, QT,
                       kQRes ? n_chunks * kTileD : kTileD, tid);
      }
      if constexpr (kWiden) {
        widen_chunk(p_s, scale_s, p_wide, tid);
        p_f = p_wide;
      }
      if (kWiden || !kQRes || s == 0) __syncthreads();
      l1_tile<QT>(q_s + l1_qg * qs, qs, p_f + l1_rg * kWStride, l1_acc);
    } else {
      // the rounded scale of each row this thread feeds (int8 rows)
      float sb[kScaled ? L::NT : 1];
      if constexpr (kScaled) {
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
          sb[nt] = round_bf16(scale_s[n_base + nt * 8 + g]);
      }
#pragma unroll
      for (int k0 = 0; k0 < kTileD; k0 += 8) {
        uint32_t ah[L::MT][4], al[L::MT][4];
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt) {
          const float* qa = q_s + (m_base + mt * 16 + g) * qs + k0 + t;
          split_tf32(qa[0], ah[mt][0], al[mt][0]);
          split_tf32(qa[8 * qs], ah[mt][1], al[mt][1]);
          split_tf32(qa[4], ah[mt][2], al[mt][2]);
          split_tf32(qa[8 * qs + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) {
          const T* pb = p_s + (n_base + nt * 8 + g) * kPS + k0 + t;
          float y0, y1;
          if constexpr (kScaled) {
            y0 = widen(pb[0], sb[nt]);
            y1 = widen(pb[4], sb[nt]);
          } else {
            y0 = widen(pb[0]);
            y1 = widen(pb[4]);
          }
          if constexpr (kExactRows) {
            const uint32_t b0 = __float_as_uint(y0), b1 = __float_as_uint(y1);
#pragma unroll
            for (int mt = 0; mt < L::MT; ++mt) {
              mma_tf32(acc[mt][nt], al[mt], b0, b1);
              mma_tf32(acc[mt][nt], ah[mt], b0, b1);
            }
          } else {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(y0, bh0, bl0);
            split_tf32(y1, bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < L::MT; ++mt) {
              mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
              mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
              mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
            }
          }
        }
      }
    }

    if (last) {
      pn_part += __shfl_xor_sync(kFull, pn_part, 1);
      if ((tid & 1) == 0) pn_s[tid >> 1] = pn_part;
      pn_part = 0.f;
    }
    __syncthreads();
    if (!last) {
      ++chunk;
      continue;
    }

    // accumulators -> scores: C fragment (g, 2t), (g, 2t+1), (g+8, 2t),
    // (g+8, 2t+1) of each m16 x n8 tile; Manhattan's sums are the scores
    if constexpr (kL1) {
#pragma unroll
      for (int i = 0; i < T1::RQ; ++i)
#pragma unroll
        for (int j = 0; j < T1::RN; ++j) {
          score_s[(l1_qg + T1::QG * i) * kSStride + l1_rg + T1::RG * j] =
              l1_acc[i][j];
          l1_acc[i][j] = 0.f;
        }
    } else {
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ql = m_base + mt * 16 + g + 8 * h;
            const int r = n_base + nt * 8 + 2 * t;
            const float qn = qn_s[ql];
            *reinterpret_cast<float2*>(&score_s[ql * kSStride + r]) =
                make_float2(score(acc[mt][nt][2 * h], pn_s[r], qn, metric),
                            score(acc[mt][nt][2 * h + 1], pn_s[r + 1], qn,
                                  metric));
            acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
          }
    }
    __syncthreads();

    // selection: warp w alone touches the lists of its own queries.  The
    // scores and k-th of query i+1 are read while query i is served (no
    // insertion changes them), so the shared-memory latency is paid once.
    bool live[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int row = tile + lane + 32 * j;
      live[j] = row < row_end && (del == nullptr || del[row] == 0);
    }
    const int n_mine = min(L::QPW, B - q0 - warp * L::QPW);   // warp-uniform
    float tau_mine = CUDART_INF_F;          // the wide selection's bound
    if constexpr (kWide) {
      if (kReadBound && bound != nullptr)
        tau_mine = read_bound<L::QPW>(bound, q0 + warp * L::QPW, B,
                                      n_splits, lane);
    }
    float next[kRowsPerLane], next_kth = 0.f;
    if (n_mine > 0) read_query(score_s, list_d, warp * L::QPW, k_run, lane,
                               next, next_kth);
    for (int i = 0; i < n_mine; ++i) {
      const int ql = warp * L::QPW + i;
      float sc[kRowsPerLane];
      float kth = next_kth;
      const float tau =
          kWide ? __shfl_sync(kFull, tau_mine, i) : CUDART_INF_F;
      float lo = CUDART_INF_F;
      // a later page admits only what follows its floor
      float fd = -CUDART_INF_F;
      int fi = -1;
      if (floor_d != nullptr) {
        fd = floor_d[q0 + ql];
        fi = floor_i[q0 + ql];
      }
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const bool after = floor_d == nullptr ||
                           lex_less(fd, fi, next[j], tile + lane + 32 * j);
        sc[j] = live[j] && after ? next[j] : CUDART_INF_F;
        if constexpr (kWide) {
          if (!(sc[j] <= tau)) sc[j] = CUDART_INF_F;
        }
        lo = fminf(lo, sc[j]);
      }
      if (i + 1 < n_mine)
        read_query(score_s, list_d, ql + 1, k_run, lane, next, next_kth);
      if (!__any_sync(kFull, lo < kth)) continue;         // the common case
      float* ld = list_d + ql * k_run;
      int* li = list_i + ql * k_run;
      // the bound's slot of (query, split) and its rank j
      const int at = (q0 + ql) * n_splits + split;
      const int jr = max(bound_rank, 1) - 1;
      if constexpr (kWide) {
        if (k_run <= kRegK) {
          select_in_registers(ld, li, sc, kth, tile, k_run, lane,
                              score_s + ql * kSStride, bound, at,
                              bound_rank);
          continue;
        }
      }
      // past kRegK the list in shared memory also publishes its j-th
      // score when it fell (where a bound is given)
      const float jth = bound != nullptr ? ld[jr] : 0.f;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        unsigned mask = __ballot_sync(kFull, sc[j] < kth);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float dv = __shfl_sync(kFull, sc[j], src);
          if (!(dv < kth)) continue;                     // warp-uniform
          // rows arrive in ascending id order, so the new entry goes after
          // every entry with an equal score
          int pos = 0;
          for (int e = lane; e < k_run; e += 32) pos += (ld[e] <= dv);
          pos = __reduce_add_sync(kFull, pos);
          for (int hi = k_run - 1; hi > pos; hi -= 32) {
            const int e = hi - lane;
            const bool mv = e > pos;
            float vd = 0.f;
            int vi = 0;
            if (mv) {
              vd = ld[e - 1];
              vi = li[e - 1];
            }
            __syncwarp();
            if (mv) {
              ld[e] = vd;
              li[e] = vi;
            }
            __syncwarp();
          }
          if (lane == 0) {
            ld[pos] = dv;
            li[pos] = tile + src + 32 * j;
          }
          __syncwarp();
          kth = ld[k_run - 1];
        }
      }
      if (kWide && bound != nullptr && lane == 0 && ld[jr] < jth)
        store_bound(bound + at, ld[jr]);
    }
    tile += kTileN;
    chunk = 0;
  }

  for (int i = 0; i < L::QPW; ++i) {
    const int ql = warp * L::QPW + i;
    const int qi = q0 + ql;
    if (qi >= B) continue;
    const size_t base = ((size_t)split * B + qi) * k_run;
    for (int e = lane; e < k_run; e += 32) {
      part_d[base + e] = list_d[ql * k_run + e];
      part_i[base + e] = list_i[ql * k_run + e];
    }
  }
}

template <int QT, bool kQRes, typename T>
__global__ void __launch_bounds__(kThreads, 2)
sweep_kernel(const float* __restrict__ q, const T* __restrict__ p,
             const unsigned char* __restrict__ del, int B, int n_rows, int D,
             bool vec_q, bool vec_p, int k_run, int metric,
             int rows_per_split, const float* __restrict__ floor_d,
             const int* __restrict__ floor_i, float* __restrict__ part_d,
             int* __restrict__ part_i) {
  sweep_block<QT, kQRes, false>(q, p, nullptr, del, B, n_rows, D, vec_q,
                                vec_p, k_run, metric, rows_per_split, floor_d,
                                floor_i, part_d, part_i, nullptr, 0);
}

// float32 / bf16 rows under the wide selection (the build's pools)
template <int QT, bool kQRes, typename T>
__global__ void __launch_bounds__(kThreads, 2)
sweep_kernel_wide(const float* __restrict__ q, const T* __restrict__ p,
                  const unsigned char* __restrict__ del, int B, int n_rows,
                  int D, bool vec_q, bool vec_p, int k_run, int metric,
                  int rows_per_split, const float* __restrict__ floor_d,
                  const int* __restrict__ floor_i,
                  float* __restrict__ part_d, int* __restrict__ part_i,
                  float* bound, int bound_rank) {
  sweep_block<QT, kQRes, true>(q, p, nullptr, del, B, n_rows, D, vec_q,
                               vec_p, k_run, metric, rows_per_split, floor_d,
                               floor_i, part_d, part_i, bound, bound_rank);
}

// int8 rows: the same sweep, each element widened with its row's scale,
// under the wide selection
template <int QT, bool kQRes>
__global__ void __launch_bounds__(kThreads, 2)
sweep_kernel_q8(const float* __restrict__ q, const int8_t* __restrict__ p,
                const float* __restrict__ scale,
                const unsigned char* __restrict__ del, int B, int n_rows,
                int D, bool vec_q, bool vec_p, int k_run, int metric,
                int rows_per_split, const float* __restrict__ floor_d,
                const int* __restrict__ floor_i, float* __restrict__ part_d,
                int* __restrict__ part_i, float* bound, int bound_rank) {
  sweep_block<QT, kQRes, true>(q, p, scale, del, B, n_rows, D, vec_q, vec_p,
                               k_run, metric, rows_per_split, floor_d,
                               floor_i, part_d, part_i, bound, bound_rank);
}

// Manhattan over float32, bf16 or int8 rows (``scale`` null but for
// int8), the CUDA cores' sum, under the wide selection
template <int QT, bool kQRes, typename T>
__global__ void __launch_bounds__(kThreads, 2)
sweep_kernel_l1(const float* __restrict__ q, const T* __restrict__ p,
                const float* __restrict__ scale,
                const unsigned char* __restrict__ del, int B, int n_rows,
                int D, bool vec_q, bool vec_p, int k_run, int metric,
                int rows_per_split, const float* __restrict__ floor_d,
                const int* __restrict__ floor_i, float* __restrict__ part_d,
                int* __restrict__ part_i, float* bound, int bound_rank) {
  sweep_block<QT, kQRes, true, T, true>(
      q, p, scale, del, B, n_rows, D, vec_q, vec_p, k_run, metric,
      rows_per_split, floor_d, floor_i, part_d, part_i, bound, bound_rank);
}

__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
             int B, int S, int k_run, int metric, float* __restrict__ out_d,
             int* __restrict__ out_i, float* __restrict__ floor_d,
             int* __restrict__ floor_i) {
  __shared__ int head[kMergeWarps][kMaxSplits];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= B) return;                                   // whole warp
  int* h = head[warp];
  for (int s = lane; s < S; s += 32) h[s] = 0;
  __syncwarp();
  for (int r = 0; r < k_run; ++r) {
    float bd = CUDART_INF_F;
    int bi = -1, bs = -1;
    for (int s = lane; s < S; s += 32) {
      const int pos = h[s];
      if (pos < k_run) {
        const size_t off = ((size_t)s * B + qi) * k_run + pos;
        const float d = part_d[off];
        const int id = part_i[off];
        if (bs < 0 || lex_less(d, id, bd, bi)) {
          bd = d;
          bi = id;
          bs = s;
        }
      }
    }
    // warp argmin over (d, id, split): a strict total order, so every lane
    // ends on the same winner
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      const int os = __shfl_xor_sync(kFull, bs, o);
      const bool take =
          os >= 0 && (bs < 0 || lex_less(od, oi, bd, bi) ||
                      (od == bd && oi == bi && os < bs));
      if (take) {
        bd = od;
        bi = oi;
        bs = os;
      }
    }
    if (lane == 0) {
      out_d[(size_t)qi * k_run + r] = metric == kMetricL2 ? sqrtf(bd) : bd;
      out_i[(size_t)qi * k_run + r] = bi;
      h[bs] += 1;
      if (floor_d != nullptr && r == k_run - 1) {    // the next page's floor
        floor_d[qi] = bd;
        floor_i[qi] = bi;
      }
    }
    __syncwarp();
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

template <int QT, bool kQRes, bool kWide, bool kL1, typename T>
cudaError_t launch_sweep(const float* q, const T* p, const float* scale,
                         const unsigned char* del, int B, int n_rows, int D,
                         int k_run, int metric, int S, size_t smem,
                         const float* floor_d, const int* floor_i,
                         float* part_d, int* part_i, float* bound,
                         int bound_rank, cudaStream_t stream) {
  const void* kernel;
  if constexpr (kL1)
    kernel = reinterpret_cast<const void*>(sweep_kernel_l1<QT, kQRes, T>);
  else if constexpr (scaled_rows<T>())
    kernel = reinterpret_cast<const void*>(sweep_kernel_q8<QT, kQRes>);
  else if constexpr (kWide)
    kernel = reinterpret_cast<const void*>(sweep_kernel_wide<QT, kQRes, T>);
  else
    kernel = reinterpret_cast<const void*>(sweep_kernel<QT, kQRes, T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_per_split =
      ceil_div(ceil_div(n_rows, S), kTileN) * kTileN;
  // 16-byte copies need 16-byte rows and a 16-byte aligned base
  const bool vec_q = (D * sizeof(float)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool vec_p = (D * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const dim3 grid(ceil_div(B, QT), S);
  if constexpr (kL1)
    sweep_kernel_l1<QT, kQRes, T><<<grid, kThreads, smem, stream>>>(
        q, p, scale, del, B, n_rows, D, vec_q, vec_p, k_run, metric,
        rows_per_split, floor_d, floor_i, part_d, part_i, bound, bound_rank);
  else if constexpr (scaled_rows<T>())
    sweep_kernel_q8<QT, kQRes><<<grid, kThreads, smem, stream>>>(
        q, p, scale, del, B, n_rows, D, vec_q, vec_p, k_run, metric,
        rows_per_split, floor_d, floor_i, part_d, part_i, bound, bound_rank);
  else if constexpr (kWide)
    sweep_kernel_wide<QT, kQRes, T><<<grid, kThreads, smem, stream>>>(
        q, p, del, B, n_rows, D, vec_q, vec_p, k_run, metric, rows_per_split,
        floor_d, floor_i, part_d, part_i, bound, bound_rank);
  else
    sweep_kernel<QT, kQRes, T><<<grid, kThreads, smem, stream>>>(
        q, p, del, B, n_rows, D, vec_q, vec_p, k_run, metric, rows_per_split,
        floor_d, floor_i, part_d, part_i);
  return cudaGetLastError();
}

// ``kWide``: the wide selection (the int8 and Manhattan instances at every
// k_run, and the float32 / bf16 wide ones, which exist at QT = 64 for
// k_run <= kRegK only); ``bound`` (f32[B, S] of +inf, or null) and
// ``bound_rank`` j as sweep_block takes them, S j >= k_run; ``kL1``: the
// Manhattan instances (metric Manhattan only, the others L2 or cosine).
template <bool kWide, bool kL1, typename T>
int run_topk(const float* q, const T* p, const float* scale,
             const unsigned char* del, int B, int n_rows, int D, int k_run,
             int metric, int qt, int S, int q_res, int smem_bytes,
             float* part_d, int* part_i, float* out_d, int* out_i,
             float* floor_d, int* floor_i, float* bound, int bound_rank,
             void* stream_ptr) {
  constexpr bool kEveryTile = scaled_rows<T>() || kL1;
  if (B <= 0 || n_rows < 0 || D <= 0 || k_run < 1 || k_run > kMaxK ||
      S < 1 || S > kMaxSplits || (qt != 64 && qt != 16) ||
      (kL1 ? metric != kMetricManhattan
           : metric != kMetricL2 && metric != kMetricCosine) ||
      (floor_d == nullptr) != (floor_i == nullptr) ||
      (scale == nullptr) == scaled_rows<T>() ||
      (kWide && !kEveryTile && (qt != 64 || k_run > kRegK)) ||
      (bound != nullptr &&
       (!kWide || bound_rank < 1 || bound_rank > k_run ||
        (long long)S * bound_rank < k_run)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sweep_smem_bytes<T, kL1>(qt, k_run, D, q_res != 0);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
  if (qt == 64)
    err = q_res ? launch_sweep<64, true, kWide, kL1>(
                      q, p, scale, del, B, n_rows, D, k_run, metric, S, smem,
                      floor_d, floor_i, part_d, part_i, bound, bound_rank,
                      stream)
                : launch_sweep<64, false, kWide, kL1>(
                      q, p, scale, del, B, n_rows, D, k_run, metric, S, smem,
                      floor_d, floor_i, part_d, part_i, bound, bound_rank,
                      stream);
  else if constexpr (!kWide || kEveryTile)
    err = q_res ? launch_sweep<16, true, kWide, kL1>(
                      q, p, scale, del, B, n_rows, D, k_run, metric, S, smem,
                      floor_d, floor_i, part_d, part_i, bound, bound_rank,
                      stream)
                : launch_sweep<16, false, kWide, kL1>(
                      q, p, scale, del, B, n_rows, D, k_run, metric, S, smem,
                      floor_d, floor_i, part_d, part_i, bound, bound_rank,
                      stream);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<ceil_div(B, kMergeWarps), kMergeWarps * 32, 0, stream>>>(
      part_d, part_i, B, S, k_run, metric, out_d, out_i, floor_d, floor_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bruteforce_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q f32[B, D], p f32[n_rows.., D] (row-major, contiguous), del u8[n_rows..]
// or null; QT (64 or 16), the corpus splits S, whether the block's queries
// stay resident (else they stream through the ring) and the sweep's
// shared-memory bytes come from ops/cuda_bruteforce._launch_shape; part_d /
// part_i hold [S, B, k_run]; out_d f32[B, k_run], out_i i32[B, k_run];
// floor_d f32[B] / floor_i i32[B], both null or both set: the page floor,
// read by the sweep and overwritten by the merge with the page's last
// entry.  Returns the CUDA error of the launches (0 on success).
int bruteforce_topk(const float* q, const float* p, const unsigned char* del,
                    int B, int n_rows, int D, int k_run, int metric, int qt,
                    int S, int q_res, int smem_bytes, float* part_d,
                    int* part_i, float* out_d, int* out_i, float* floor_d,
                    int* floor_i, void* stream_ptr) {
  return run_topk<false, false>(q, p, nullptr, del, B, n_rows, D, k_run,
                                metric, qt, S, q_res, smem_bytes, part_d,
                                part_i, out_d, out_i, floor_d, floor_i,
                                nullptr, 0, stream_ptr);
}

// The same with p bf16[n_rows.., D] (its raw 16-bit patterns).
int bruteforce_topk_bf16(const float* q, const void* p,
                         const unsigned char* del, int B, int n_rows, int D,
                         int k_run, int metric, int qt, int S, int q_res,
                         int smem_bytes, float* part_d, int* part_i,
                         float* out_d, int* out_i, float* floor_d,
                         int* floor_i, void* stream_ptr) {
  return run_topk<false, false>(q,
                                static_cast<const uint16_t*>(p), nullptr, del,
                                B, n_rows, D, k_run, metric, qt, S, q_res,
                                smem_bytes, part_d, part_i, out_d, out_i,
                                floor_d, floor_i, nullptr, 0, stream_ptr);
}

// The wide selection for the build's pools (k_run <= 256, QT = 64) over
// float32 / bf16 rows: as bruteforce_topk / _bf16, plus bound f32[B, S]
// of +inf (or null: no bound shared across splits) and its rank
// bound_rank = ceil(k_run / S).
int bruteforce_topk_wide(const float* q, const float* p,
                         const unsigned char* del, int B, int n_rows, int D,
                         int k_run, int metric, int qt, int S, int q_res,
                         int smem_bytes, float* part_d, int* part_i,
                         float* out_d, int* out_i, float* floor_d,
                         int* floor_i, float* bound, int bound_rank,
                         void* stream_ptr) {
  return run_topk<true, false>(q, p, nullptr, del, B, n_rows, D, k_run,
                               metric, qt, S, q_res, smem_bytes, part_d,
                               part_i, out_d, out_i, floor_d, floor_i, bound,
                               bound_rank, stream_ptr);
}

int bruteforce_topk_bf16_wide(const float* q, const void* p,
                              const unsigned char* del, int B, int n_rows,
                              int D, int k_run, int metric, int qt, int S,
                              int q_res, int smem_bytes, float* part_d,
                              int* part_i, float* out_d, int* out_i,
                              float* floor_d, int* floor_i, float* bound,
                              int bound_rank, void* stream_ptr) {
  return run_topk<true, false>(q, static_cast<const uint16_t*>(p), nullptr,
                               del, B, n_rows, D, k_run, metric, qt, S, q_res,
                               smem_bytes, part_d, part_i, out_d, out_i,
                               floor_d, floor_i, bound, bound_rank,
                               stream_ptr);
}

// The same with int8 rows p i8[n_rows.., D] and their scales
// scale f32[n_rows..]: a row element is bf16(bf16(p) * bf16(scale)); the
// wide selection at k_run <= 256 (bound as bruteforce_topk_wide's).
int bruteforce_topk_q8(const float* q, const void* p, const float* scale,
                       const unsigned char* del, int B, int n_rows, int D,
                       int k_run, int metric, int qt, int S, int q_res,
                       int smem_bytes, float* part_d, int* part_i,
                       float* out_d, int* out_i, float* floor_d,
                       int* floor_i, float* bound, int bound_rank,
                       void* stream_ptr) {
  return run_topk<true, false>(q, static_cast<const int8_t*>(p), scale, del,
                               B, n_rows, D, k_run, metric, qt, S, q_res,
                               smem_bytes, part_d, part_i, out_d, out_i,
                               floor_d, floor_i, bound, bound_rank,
                               stream_ptr);
}

// Manhattan (metric 2 only) over float32, bf16 and int8 rows: arguments as
// bruteforce_topk_wide's (the int8 entry's as bruteforce_topk_q8's), the
// wide selection at every k_run up to 256 (bound as bruteforce_topk_wide's)
// and the insertion into shared memory past it (QT = 16).
int bruteforce_topk_l1(const float* q, const float* p,
                       const unsigned char* del, int B, int n_rows, int D,
                       int k_run, int metric, int qt, int S, int q_res,
                       int smem_bytes, float* part_d, int* part_i,
                       float* out_d, int* out_i, float* floor_d,
                       int* floor_i, float* bound, int bound_rank,
                       void* stream_ptr) {
  return run_topk<true, true>(q, p, nullptr, del, B, n_rows, D, k_run,
                              metric, qt, S, q_res, smem_bytes, part_d,
                              part_i, out_d, out_i, floor_d, floor_i, bound,
                              bound_rank, stream_ptr);
}

int bruteforce_topk_bf16_l1(const float* q, const void* p,
                            const unsigned char* del, int B, int n_rows,
                            int D, int k_run, int metric, int qt, int S,
                            int q_res, int smem_bytes, float* part_d,
                            int* part_i, float* out_d, int* out_i,
                            float* floor_d, int* floor_i, float* bound,
                            int bound_rank, void* stream_ptr) {
  return run_topk<true, true>(q, static_cast<const uint16_t*>(p), nullptr,
                              del, B, n_rows, D, k_run, metric, qt, S, q_res,
                              smem_bytes, part_d, part_i, out_d, out_i,
                              floor_d, floor_i, bound, bound_rank,
                              stream_ptr);
}

int bruteforce_topk_q8_l1(const float* q, const void* p, const float* scale,
                          const unsigned char* del, int B, int n_rows, int D,
                          int k_run, int metric, int qt, int S, int q_res,
                          int smem_bytes, float* part_d, int* part_i,
                          float* out_d, int* out_i, float* floor_d,
                          int* floor_i, float* bound, int bound_rank,
                          void* stream_ptr) {
  return run_topk<true, true>(q, static_cast<const int8_t*>(p), scale, del,
                              B, n_rows, D, k_run, metric, qt, S, q_res,
                              smem_bytes, part_d, part_i, out_d, out_i,
                              floor_d, floor_i, bound, bound_rank,
                              stream_ptr);
}

}  // extern "C"
