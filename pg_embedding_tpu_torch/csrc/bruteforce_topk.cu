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
// Not here: a persistent grid, one launch for k_run > 1024; wgmma, the
// copy engine and a selector warpgroup are the Hopper instances' (below,
// sweep_wgmma_kernel, which takes the exact route's short lists, and
// sweep_q8_wgmma_kernel, the build's int8 pools).
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
// entries (QT = 16) keep the insertion into shared memory.  The int8
// rows' build pools at D <= 128 take a Hopper instance (below,
// sweep_q8_wgmma_kernel: bf16 wgmma with the query split in three bf16
// parts, this wide selection in selector warpgroups).
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

#include <cuda.h>  // CUtensorMap; its encoder is found at run time
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

// ---------------------------------------------------------------------
// The Hopper instances of the exact route (sweep_wgmma_kernel; C entries
// bruteforce_topk_wgmma and bruteforce_topk_bf16_wgmma): float32 / bf16
// rows, L2 and cosine, k_run < kWMaxK, D <= kWMaxD, 16-byte rows and base,
// no page floor (ops/cuda_bruteforce._wgmma_route is the rule; everything
// else keeps the mma.sync instances above).  The same function as
// sweep_kernel's QT = 64 tier, scored on Hopper's own paths:
//  * Products on wgmma.mma_async m64n64k8 .tf32 with 3xTF32 kept: the
//    corpus rows are A (64 rows a consumer warpgroup, two warpgroups a
//    128-row tile), loaded from the landed ring stage into registers and
//    split there (split_tf32, the same rounding as the mma.sync
//    instances); the block's 64 queries are B, split once per block into
//    hi and lo tiles in shared memory in wgmma's K-major no-swizzle layout
//    and read by matrix descriptors.  Per 8-dim step p_hi.q_lo + p_lo.q_hi
//    + p_hi.q_hi into float32 accumulators (bf16 rows, exact in TF32:
//    p.q_lo + p.q_hi).  A thread's 8 dims of a row are consecutive in the
//    stage (two 16-byte loads, float32; one, bf16), so step s of a 32-dim
//    chunk pairs column t with dim 8t + 2s and column t + 4 with dim 8t +
//    2s + 1; the query tiles are laid out in the same order, so a step
//    sums dims {8t + 2s, 8t + 2s + 1 : t < 4} (tests/test_torch_tf32_split
//    emulates that order).  A chunk's products are one wgmma group,
//    retired before the next chunk's rows are split (see w_group): the
//    two consumer warpgroups' groups take turns on the tensor cores.
//  * Copies by the copy engine: kWStages<T>() ring stages in flight, each
//    a [128 x 32] chunk of the rows landed by one cp.async.bulk.tensor
//    copy (a tensor map of the [n_rows, D] rows; rows past n_rows and dims
//    past D land as zeros) on a full mbarrier.  A consumer warp arrives
//    on the stage's empty mbarrier as soon as its loads of it are done,
//    and the arrival that ends the phase issues the stage's next copy (no
//    producer warp: its registers went to a second selector warpgroup).
//    No block barrier a chunk.  One copy a row (the plain
//    cp.async.bulk of beam_walk.cu, 512 copies a tile) took 17.6 ms at the
//    main path's shape, float32 and bf16 alike: bound by the copies'
//    count.  A float32 stage's rows are 128 bytes apart, so odd rows read
//    their two 16-byte halves in the other order (no bank conflict).  Rows
//    past the split's end reach only their own scores, which the
//    selection masks.
//  * The selection off the products' path: two selector warpgroups (8
//    queries a warp) take each tile's scores from a double-buffered score
//    tile, handed over by named barriers, while the consumers compute the
//    next tile's products; a list of k_run < 64 lives in two registers a
//    lane while its query takes a tile (w_insert).  The admission rule,
//    the lists' order and merge_kernel are the mma.sync instances'
//    (strict < against the k-th the list had at the tile's start, rows in
//    ascending id), so results keep their (score, id) order.
//  * |p|^2 from the A values a consumer thread already holds (its 8 dims
//    of rows g and g + 8 a chunk), summed over the four lanes of a row.
// One block an SM: 512 threads (2 consumer and 2 selector warpgroups, 128
// registers a thread), the ring, the query tiles, two score tiles and the
// lists in up to ~211 KB of shared memory (wgmma_smem_bytes, which the
// launch checks against the caller's).  What bounds it is sweep_kernel's:
// the products, 3 (bf16: 2) TF32 passes.  Not here: a persistent grid,
// clusters, a group kept in flight while the next is split.
constexpr int kWQT = 64;                       // queries a block (wgmma N)
constexpr int kWThreads = 4 * 128;             // 2 consumer, 2 selector WGs
constexpr int kWSelectorWarp0 = 8;
constexpr int kWMaxD = 128;
constexpr int kWMaxK = 64;
constexpr int kWSStride = kTileN + 4;          // score tile row stride (floats)
constexpr int kWScoreBufs = 2;                 // score tiles in turn
constexpr int kWBarBytes = 128;             // the ring's mbarriers
constexpr int kWQPW = kWQT / 8;                // queries each selector warp takes
// named barriers: score tile b full (1 + b) and free again (1 +
// kWScoreBufs + b), each among the consumer and selector warpgroups
// (sweep_probe's runs found one tile, three, and a barrier pair per
// consumer warpgroup no faster)
constexpr int kWBarFull = 1;
constexpr int kWBarFree = 1 + kWScoreBufs;
constexpr int kWBarThreads = kWThreads;

// ring stages by row type (48 KB either way) and a stage's bytes: the
// tensor copy's dense [128 x 32] box
template <typename T>
__host__ __device__ constexpr int kWStages() {
  return sizeof(T) == 4 ? 3 : 6;
}
template <typename T>
__host__ __device__ constexpr int w_stage_bytes() {
  return kTileN * kTileD * (int)sizeof(T);
}

// Shared memory: the ring (first: a tensor copy lands 128-byte aligned),
// the query hi and lo tiles (D in whole 32-dim chunks, 64 queries), two
// [64 x 132] score tiles, |q|^2, the ring's mbarriers, the [64 x k_run]
// lists (score, id).
template <typename T>
size_t wgmma_smem_bytes(int k_run, int D) {
  const size_t chunks = (size_t)(D + kTileD - 1) / kTileD;
  return (size_t)kWStages<T>() * w_stage_bytes<T>() +
         2 * chunks * kTileD * kWQT * 4 +
         (size_t)kWScoreBufs * kWQT * kWSStride * 4 +
         kWQT * 4 + kWBarBytes + (size_t)8 * kWQT * k_run;
}

__device__ __forceinline__ unsigned w_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void w_mbar_init(unsigned long long* bar,
                                            unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   w_smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void w_mbar_arrive_expect(unsigned long long* bar,
                                                     unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          w_smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The [128 x 32] box of ``map`` at (dim x, row y) into dst by the copy
// engine, completing its bytes on ``bar``.
__device__ __forceinline__ void w_tensor_copy(void* dst, const CUtensorMap* map,
                                              int x, int y,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(w_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(w_smem_addr(bar))
      : "memory");
}

// Arrives on ``bar``; true for the arrival that ends the phase (it
// acquires the other arrivals, as a wait would).
__device__ __forceinline__ bool w_mbar_arrive_last(unsigned long long* bar) {
  unsigned last;
  asm volatile(
      "{\n .reg .b64 st;\n .reg .b32 n;\n .reg .pred p, q;\n"
      " mbarrier.arrive.shared::cta.b64 st, [%1];\n"
      " mbarrier.pending_count.b64 n, st;\n"
      " setp.eq.u32 p, n, 1;\n"
      " @p mbarrier.test_wait.shared::cta.b64 q, [%1], st;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(last)
      : "r"(w_smem_addr(bar))
      : "memory");
  return last != 0;
}

// Waits for the phase of parity ``phase`` to end; a copy that has not
// landed after 10 s of the global timer traps (a launch error in place of
// a card that never answers).
__device__ __forceinline__ void w_mbar_wait(unsigned long long* bar,
                                            unsigned phase) {
  unsigned long long start = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(w_smem_addr(bar)), "r"(phase)
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

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A K-major, unswizzled wgmma operand in shared memory: core matrices of 8
// rows x 16 bytes (rows 16 bytes apart), the next 4 columns ``lbo`` bytes
// on, the next 8 rows ``sbo`` bytes on.
__device__ __forceinline__ uint64_t w_desc(const void* p, unsigned lbo,
                                           unsigned sbo) {
  return (uint64_t)((w_smem_addr(p) & 0x3ffffu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void w_fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T on a warpgroup: A [64 x 8] TF32 from registers (thread
// (g, t) of warp w: rows 16 w + g, + 8, columns t, t + 4), B [64 x 8] TF32
// from shared memory by ``desc``; ``acc`` 0 overwrites d.  d[4 i + 2 h +
// e] is row 16 w + g + 8 h, column 8 i + 2 t + e.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Element (query n, dim d) of a query tile: chunk c = d / 32, and in it
// step s = d % 8 / 2, column half d % 2, column d % 32 / 8 of the half;
// each (chunk, step) is two [64 x 4] halves of 16-byte rows, 1 KB apart.
__device__ __forceinline__ int w_q_offset(int n, int d) {
  const int c = d / kTileD, r = d % kTileD;
  return ((((c * 4 + (r & 7) / 2) * 2 + (r & 1)) * kWQT + n) * 4) + r / 8;
}

// 8-dim steps a wgmma group takes (a chunk is 4): sweep_probe's wgmma-2
// variant times 2
constexpr int kWGroupSteps = 4;

// kWGroupSteps 8-dim steps of a consumer warpgroup's products from s0:
// split the thread's A values ``x`` (rows g, g + 8 of the chunk's dims 8t
// .. 8t + 7; step s takes dims 8t + 2s, 8t + 2s + 1) into TF32 A registers
// and issue the group (``first``: the tile's first, whose first product
// overwrites the accumulators); ``meanwhile`` runs while it does, then the
// group is retired.  A group's A registers are read until the wait that
// retires it; keeping one in flight while the next chunk's rows were
// loaded and split (two A sets, wait_group 1) gave wrong bf16 scores on
// the card, operand fences or not, so each group is retired before the
// next is written: the other consumer warpgroup's products fill the
// tensor cores meanwhile.
template <typename T, typename Meanwhile>
__device__ __forceinline__ void w_group(const float (&x)[2][8], int s0,
                                        uint64_t desc_hi, uint64_t desc_lo,
                                        bool first, float (&acc)[32],
                                        const Meanwhile& meanwhile) {
  uint32_t ah[kWGroupSteps][4], al[kWGroupSteps][4];
  // step s: a0 (row g, dim 8t + 2s), a1 (row g + 8), a2 / a3 the next dim
#pragma unroll
  for (int j = 0; j < kWGroupSteps; ++j) {
    const int s = s0 + j;
    const float v[4] = {x[0][2 * s], x[1][2 * s], x[0][2 * s + 1],
                        x[1][2 * s + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (std::is_same<T, float>::value)
        split_tf32(v[e], ah[j][e], al[j][e]);
      else
        ah[j][e] = __float_as_uint(v[e]);
    }
  }
  w_fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kWGroupSteps; ++j) {
    // (chunk, step)'s query halves are 2 KB apart
    const uint64_t step = (uint64_t)((s0 + j) * 2 * kWQT * 16) >> 4;
    const int keep = first && j == 0 ? 0 : 1;
    if constexpr (std::is_same<T, float>::value) {
      wgmma_tf32(acc, ah[j], desc_lo + step, keep);
      wgmma_tf32(acc, al[j], desc_hi + step, 1);
      wgmma_tf32(acc, ah[j], desc_hi + step, 1);
    } else {
      wgmma_tf32(acc, ah[j], desc_lo + step, keep);
      wgmma_tf32(acc, ah[j], desc_hi + step, 1);
    }
  }
  wgmma_commit();
  meanwhile();
  wgmma_wait<0>();
  w_fence_acc(acc);
}

// One ring stage's chunk for a consumer warpgroup: wait for it, read the
// thread's 8 dims of rows g and g + 8 (``row0``: the warp's first row) and
// issue the chunk's groups; under the first, release the stage (an
// arrival on ``empty``; the eighth warp's refills it, ``refill``) and add
// the squares to ``pn``.
template <typename T, typename Refill>
__device__ __forceinline__ void w_chunk(unsigned char* stage,
                                        unsigned long long* full,
                                        unsigned long long* empty,
                                        unsigned phase,
                                        int row0, int lane, uint64_t desc_hi,
                                        uint64_t desc_lo, bool first,
                                        float (&acc)[32], float (&pn)[2],
                                        const Refill& refill) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int kRow = kTileD * (int)sizeof(T);
  w_mbar_wait(full, phase);
  // x[h][j]: dim 8t + j of row g + 8 h
  float x[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned char* row = stage + (row0 + g + 8 * h) * kRow;
    if constexpr (std::is_same<T, float>::value) {
      // 128-byte rows: an odd row reads its halves the other way round,
      // so rows g and g + 1 of a quarter warp take other banks
      const int odd = g & 1;
      const float4 a = *reinterpret_cast<const float4*>(row + 32 * t +
                                                        16 * odd);
      const float4 b = *reinterpret_cast<const float4*>(row + 32 * t + 16 -
                                                        16 * odd);
      const float4 lo = odd ? b : a, hi = odd ? a : b;
      x[h][0] = lo.x; x[h][1] = lo.y; x[h][2] = lo.z; x[h][3] = lo.w;
      x[h][4] = hi.x; x[h][5] = hi.y; x[h][6] = hi.z; x[h][7] = hi.w;
    } else {
      const uint4 w = *reinterpret_cast<const uint4*>(row + 16 * t);
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        x[h][2 * m] = __uint_as_float(ws[m] << 16);
        x[h][2 * m + 1] = __uint_as_float(ws[m] & 0xffff0000u);
      }
    }
  }
  const auto release = [&] {
    __syncwarp();
    if (lane == 0 && w_mbar_arrive_last(empty)) refill();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) pn[h] = fmaf(x[h][j], x[h][j], pn[h]);
  };
  w_group<T>(x, 0, desc_hi, desc_lo, first, acc, release);
#pragma unroll
  for (int s0 = kWGroupSteps; s0 < 4; s0 += kWGroupSteps)
    w_group<T>(x, s0, desc_hi, desc_lo, false, acc, [] {});
}

// The rows of a tile that one query admits (sc: lane l's rows l + 32 j,
// masked rows +inf) inserted into its list (ld, li) of k_run < 64
// entries, held in two registers a lane while it takes them (entry 32 r +
// lane): the same insertion as the mma.sync instances' (a row goes after
// every entry of its score, rows in ascending id, skipped once the k-th
// has fallen to it), by two votes and a shuffle where the list in shared
// memory took a round of reads, writes and warp barriers.
__device__ __forceinline__ void w_insert(float* ld, int* li,
                                         const float (&sc)[kRowsPerLane],
                                         int tile, int k_run, int lane) {
  const bool in0 = lane < k_run, in1 = lane + 32 < k_run;
  float d0 = in0 ? ld[lane] : CUDART_INF_F;
  int i0 = in0 ? li[lane] : -1;
  float d1 = in1 ? ld[lane + 32] : CUDART_INF_F;
  int i1 = in1 ? li[lane + 32] : -1;
  const int last = k_run - 1;                            // warp-uniform
  float kth = __shfl_sync(kFull, last >= 32 ? d1 : d0, last & 31);
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    unsigned mask = __ballot_sync(kFull, sc[j] < kth);
    while (mask) {
      const int src = __ffs(mask) - 1;
      const float dv = __shfl_sync(kFull, sc[j], src);
      const int iv = tile + src + 32 * j;
      const int pos = __popc(__ballot_sync(kFull, in0 && d0 <= dv)) +
                      __popc(__ballot_sync(kFull, in1 && d1 <= dv));
      // entries from pos move up one: lane 0's second takes lane 31's first
      const float u0 = __shfl_up_sync(kFull, d0, 1);
      const int v0 = __shfl_up_sync(kFull, i0, 1);
      float u1 = __shfl_up_sync(kFull, d1, 1);
      int v1 = __shfl_up_sync(kFull, i1, 1);
      const float w = __shfl_sync(kFull, d0, 31);
      const int wi = __shfl_sync(kFull, i0, 31);
      if (lane == 0) {
        u1 = w;
        v1 = wi;
      }
      if (lane > pos) {
        d0 = u0;
        i0 = v0;
      } else if (lane == pos) {
        d0 = dv;
        i0 = iv;
      }
      if (lane + 32 > pos) {
        d1 = u1;
        i1 = v1;
      } else if (lane + 32 == pos) {
        d1 = dv;
        i1 = iv;
      }
      kth = __shfl_sync(kFull, last >= 32 ? d1 : d0, last & 31);
      // the rows left that still score under the fallen k-th
      mask &= (mask - 1) & __ballot_sync(kFull, sc[j] < kth);
    }
  }
  if (in0) {
    ld[lane] = d0;
    li[lane] = i0;
  }
  if (in1) {
    ld[lane + 32] = d1;
    li[lane + 32] = i1;
  }
  __syncwarp();
}

// One selector warp's kWQPW queries from q_first (n_mine of them real)
// over a tile's scores (score_s: [64 x kWSStride], rows tile + 0..127):
// first every query's least live score against its k-th at once (kWQPW
// independent votes: one warp alone on its SM sub-partition cannot hide
// a chain of loads and votes a query), then the queries with a row under
// their k-th insert their rows (w_insert), rows masked past row_end and
// by the tombstones.
__device__ __forceinline__ void w_select_tile(const float* score_s,
                                              float* list_d, int* list_i,
                                              const unsigned char* del,
                                              int tile, int row_end,
                                              int q_first, int n_mine,
                                              int k_run, int lane) {
  bool live[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int row = tile + lane + 32 * j;
    live[j] = row < row_end && (del == nullptr || del[row] == 0);
  }
  // lane i holds query i's k-th
  const float kth_i = lane < n_mine
                          ? list_d[(q_first + lane) * k_run + k_run - 1]
                          : -CUDART_INF_F;
  unsigned todo = 0;
#pragma unroll
  for (int i = 0; i < kWQPW; ++i) {
    float lo = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const float v = score_s[(q_first + i) * kWSStride + lane + 32 * j];
      lo = fminf(lo, live[j] ? v : CUDART_INF_F);
    }
    if (__any_sync(kFull, lo < __shfl_sync(kFull, kth_i, i))) todo |= 1u << i;
  }
  while (todo) {                                         // warp-uniform
    const int ql = q_first + __ffs(todo) - 1;
    todo &= todo - 1;
    float sc[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j)
      sc[j] = live[j] ? score_s[ql * kWSStride + lane + 32 * j]
                      : CUDART_INF_F;
    w_insert(list_d + ql * k_run, list_i + ql * k_run, sc, tile, k_run,
             lane);
  }
}

// One block: queries [blockIdx.x 64, + 64) against split blockIdx.y's
// rows, the running lists written to part_d / part_i (as sweep_block).
// ``rows``: the tensor map of the [n_rows, D] rows (box [128 x 32]).
template <typename T>
__global__ void __launch_bounds__(kWThreads, 1)
sweep_wgmma_kernel(const float* __restrict__ q,
                   const __grid_constant__ CUtensorMap rows,
                   const unsigned char* __restrict__ del, int B, int n_rows,
                   int D, int k_run, int metric, int rows_per_split,
                   float* __restrict__ part_d, int* __restrict__ part_i) {
  constexpr int kRing = kWStages<T>();
  constexpr int kStageBytes = w_stage_bytes<T>();
  static_assert(2 * kRing * 8 <= kWBarBytes, "the mbarriers fit");
  const int n_chunks = (D + kTileD - 1) / kTileD;
  const int q_tile_floats = n_chunks * kTileD * kWQT;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* q_hi = reinterpret_cast<float*>(ring + kRing * kStageBytes);
  float* q_lo = q_hi + q_tile_floats;
  float* score_s = q_lo + q_tile_floats;
  float* qn_s = score_s + kWScoreBufs * kWQT * kWSStride;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(qn_s + kWQT);
  unsigned long long* empty = full + kRing;
  float* list_d = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(full) + kWBarBytes);
  int* list_i = reinterpret_cast<int*>(list_d + kWQT * k_run);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kWQT;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n_rows, row_begin + rows_per_split);

  // step s of the sweep is (tile s / n_chunks, chunk s % n_chunks), in
  // ring stage s % kRing: its copy
  const int total =
      (row_end > row_begin ? (row_end - row_begin + kTileN - 1) / kTileN
                           : 0) * n_chunks;
  const auto copy_step = [&](int s) {
    const int stage = s % kRing;
    w_mbar_arrive_expect(full + stage, kStageBytes);
    w_tensor_copy(ring + stage * kStageBytes, &rows,
                  (s % n_chunks) * kTileD, row_begin + s / n_chunks * kTileN,
                  full + stage);
  };
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      w_mbar_init(full + s, 1);
      w_mbar_init(empty + s, 8);             // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kRing && s < total; ++s) copy_step(s);
  }
  for (int e = tid; e < kWQT * k_run; e += kWThreads) {
    list_d[e] = CUDART_INF_F;
    list_i[e] = -1;
  }
  for (int i = warp; i < kWQT; i += kWThreads / 32) {    // |q|^2
    const int qi = q0 + i;
    float s = 0.f;
    if (qi < B)
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)qi * D + d];
        s = fmaf(v, v, s);
      }
    s = warp_sum(s);
    if (lane == 0) qn_s[i] = s;
  }
  // the query tiles, split once (zero past B and D)
  for (int e = tid; e < q_tile_floats; e += kWThreads) {
    const int n = e / (n_chunks * kTileD), d = e % (n_chunks * kTileD);
    const float x =
        q0 + n < B && d < D ? q[(size_t)(q0 + n) * D + d] : 0.f;
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    const int at = w_q_offset(n, d);
    q_hi[at] = __uint_as_float(hi);
    q_lo[at] = __uint_as_float(lo);
  }
  // the tiles are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp < kWSelectorWarp0) {
    // a consumer warpgroup: rows 64 (warp / 4) + 16 (warp % 4) + g, + 8
    const int row0 = 64 * (warp / 4) + 16 * (warp % 4);
    const int g = lane >> 2, t = lane & 3;
    const uint64_t desc_hi = w_desc(q_hi, kWQT * 16, 128);
    const uint64_t desc_lo = w_desc(q_lo, kWQT * 16, 128);
    // a chunk's (4 steps x 2 halves) query tiles: 8 KB
    const uint64_t chunk_step = (uint64_t)(4 * 2 * kWQT * 16) >> 4;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    int stage = 0, step = 0;
    unsigned phase = 0;
    int it = 0;
    for (int tile = row_begin; tile < row_end; tile += kTileN, ++it) {
      float pn[2] = {0.f, 0.f};
      for (int c = 0; c < n_chunks; ++c, ++step) {
        const int next = step + kRing;
        w_chunk<T>(ring + stage * kStageBytes, full + stage,
                   empty + stage, phase, row0, lane,
                   desc_hi + c * chunk_step, desc_lo + c * chunk_step, c == 0,
                   acc, pn, [&] {
                     if (next < total) copy_step(next);
                   });
        if (++stage == kRing) {
          stage = 0;
          phase ^= 1u;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pn[h] += __shfl_xor_sync(kFull, pn[h], 1);
        pn[h] += __shfl_xor_sync(kFull, pn[h], 2);
      }
      // score tile it % kWScoreBufs is free once tile it - kWScoreBufs is
      // selected
      const int buf = it % kWScoreBufs;
      if (it >= kWScoreBufs) named_bar_sync(kWBarFree + buf, kWBarThreads);
      float* sc = score_s + buf * kWQT * kWSStride;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = 8 * i + 2 * t + e;
          const float qn = qn_s[ql];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sc[ql * kWSStride + row0 + g + 8 * h] =
                score(acc[4 * i + 2 * h + e], pn[h], qn, metric);
        }
      named_bar_arrive(kWBarFull + buf, kWBarThreads);
    }
  } else {
    // the selector warpgroups: warp w takes queries 8 (w - 8) to + 8
    const int q_first = kWQPW * (warp - kWSelectorWarp0);
    const int n_mine = min(kWQPW, B - q0 - q_first);       // warp-uniform
    int it = 0;
    for (int tile = row_begin; tile < row_end; tile += kTileN, ++it) {
      const int buf = it % kWScoreBufs;
      named_bar_sync(kWBarFull + buf, kWBarThreads);
      // the selection of a tile
      if (n_mine > 0)
        w_select_tile(score_s + buf * kWQT * kWSStride, list_d, list_i, del,
                      tile, row_end, q_first, n_mine, k_run, lane);
      // the selection of a tile: end
      if (tile + kWScoreBufs * kTileN < row_end)
        named_bar_arrive(kWBarFree + buf, kWBarThreads);
    }
    for (int i = 0; i < n_mine; ++i) {
      const int ql = q_first + i;
      const size_t base = ((size_t)blockIdx.y * B + q0 + ql) * k_run;
      for (int e = lane; e < k_run; e += 32) {
        part_d[base + e] = list_d[ql * k_run + e];
        part_i[base + e] = list_i[ql * k_run + e];
      }
    }
  }
}

// ---------------------------------------------------------------------
// The Hopper instance of the build's int8 pools (sweep_q8_wgmma_kernel;
// C entry bruteforce_topk_q8_wgmma): int8 rows x their scales, L2 and
// cosine, k_run <= kWQ8MaxK (the wide selection's lists), D <= kWMaxD,
// 16-byte rows, row base and scale base, no page floor
// (ops/cuda_bruteforce._wgmma_route is the rule; everything else keeps
// sweep_kernel_q8).  It computes what sweep_kernel_q8 computes: the row
// element bf16(bf16(q) * bf16(scale)) by the same integer rounding
// (widen), the same scores and (score, id) order, the wide selection with
// the bound the splits share, merge_kernel over the S partial lists.
// What bounds it (1M x 128-d, one 256-row insert batch, k_run = 256): the
// products, 2 B N D = 65.5 GFLOP in 3 bf16 passes at 989 TFLOP/s = 0.199
// ms; the shadow is 132 MB, 0.040 ms.  Only the score path and the
// selection's placement differ from sweep_kernel_q8:
//  * Products on wgmma.mma_async m64n64k16 .f32.bf16.bf16.  The rows are A
//    from registers (64 rows a consumer warpgroup, two a 128-row tile):
//    each consumer thread widens its own fragment from the landed int8
//    stage with its rows' rounded scales, an element exact in bf16.  The
//    block's 64 queries are B, split once into three bf16 tiles in shared
//    memory, x = hi + mid + lo exactly (split3_bf16: truncation, as
//    csrc/pq_topk.cu's split3), in wgmma's K-major no-swizzle layout,
//    read by descriptors.  A k16 step takes lo, then mid, then hi into
//    float32 accumulators.  A thread's 8 int8 dims of a row are consecutive
//    in the stage (one 8-byte load), so step s of a 32-dim chunk pairs its
//    columns 2t, 2t + 1 with dims 8t + 4s, + 1 and columns 2t + 8, 2t + 9
//    with dims 8t + 4s + 2, + 3; the query tiles are laid out in the same
//    order (w8_q_offset; tests/test_torch_sweep_q8_wgmma.py emulates it).
//    A chunk's six wgmma are one group, retired before the next chunk is
//    widened (see w_group: two A register sets in flight gave wrong bf16
//    scores on the card).  Two TF32 passes (sweep_wgmma_kernel's split)
//    would take 64 KB of query tiles, leave no room for a ring beside
//    the lists, and bound at 0.265 ms.
//  * Copies by the copy engine: kWQ8Stages ring stages, each an int8
//    [128 x 32] box of the rows (a tensor map of the [n_rows, D] rows:
//    rows past n_rows land as zeros, masked by the selection) and, with a
//    tile's first chunk, the tile's 128 scales (a 1-d tensor map of the
//    scales, zero past n_rows) on the same full mbarrier.  The consumer
//    arrival that ends a stage's phase issues its next copy.  Both maps
//    are made per launch on the host: the build's base grows every batch.
//  * The wide selection off the products' path: two selector warpgroups,
//    8 queries a warp, read their queries' scores of a tile into
//    registers and hand the score tile back at once, so the consumers
//    compute and write the next tile while the selectors merge.  PR 12's
//    rules are kept: the bound f32[B, S] read before each tile (admission
//    at <=), the list in registers while its query takes a tile, a tile's
//    admitted rows merged 32 at a time (select_in_registers, merge_tile),
//    staged through a small buffer of the selector warp's own (the
//    consumers write the next tile into the score tile).
//  * |p|^2 from the widened values a consumer thread holds.
// Shared memory at the build's shape (k_run 256, D 128): the lists 131,072
// bytes, the three query tiles 49,152, one [64 x 132] score tile 33,792
// (a second does not fit), |q|^2 256, the mbarriers 128, the selectors'
// staging 2,048, the ring 3 x 4,608: 230,272 of 232,448.  512 threads, one
// block an SM (q8_wgmma_smem_bytes, which the launch checks against the
// caller's).  Not here: a persistent grid, clusters, setmaxnreg.
constexpr int kWQ8MaxK = kRegK;
constexpr int kWQ8Stages = 3;
constexpr int kWQ8ScaleBytes = kTileN * 4;          // a tile's scales
constexpr int kWQ8StageBytes = kTileN * kTileD + kWQ8ScaleBytes;
constexpr int kWQ8Parts = 3;                        // hi, mid, lo
// a selector warp's staging of a tile merge (merge_tile's 64 words)
constexpr int kWQ8StageWords = 64;
constexpr int kWQ8SelectorWarps = 8;
// tiles between a selector warp's reads of the shared bound
constexpr int kWQ8BoundTiles = 1;
// named barriers: the score tile full (1) and free again (2), among the
// consumer and selector warpgroups
constexpr int kWQ8BarFull = 1;
constexpr int kWQ8BarFree = 2;

// Shared memory: the ring (first: a tensor copy lands 128-byte aligned;
// a stage is its [128 x 32] int8 box, then the tile's scales), the query
// hi / mid / lo tiles (bf16, D in whole 32-dim chunks, 64 queries), the
// [64 x 132] score tile, |q|^2, the ring's mbarriers, the selector warps'
// staging (64 words each), the [64 x k_run] lists (score, id).
size_t q8_wgmma_smem_bytes(int k_run, int D) {
  const size_t chunks = (size_t)(D + kTileD - 1) / kTileD;
  return (size_t)kWQ8Stages * kWQ8StageBytes +
         (size_t)kWQ8Parts * chunks * kTileD * kWQT * 2 +
         (size_t)kWQT * kWSStride * 4 + kWQT * 4 + kWBarBytes +
         (size_t)kWQ8SelectorWarps * kWQ8StageWords * 4 +
         (size_t)8 * kWQT * k_run;
}

// The 1-d box of ``map`` at x into dst by the copy engine (the scales)
__device__ __forceinline__ void w_tensor_copy_1d(void* dst,
                                                 const CUtensorMap* map,
                                                 int x,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(w_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(w_smem_addr(bar))
      : "memory");
}

// x = hi + mid + lo exactly, each part a bf16 value (its float32's top 16
// bits) cut by truncation: hi keeps x's top 8 significant bits, the rest
// (at most 16 bits) splits into mid's 8 and lo's.  csrc/pq_topk.cu's
// split3 for one element; the parts' bf16 bits.
__device__ __forceinline__ void split3_bf16(float x, uint16_t& hi,
                                            uint16_t& mid, uint16_t& lo) {
  const float h = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
  const float r = __fsub_rn(x, h);
  const float m = __uint_as_float(__float_as_uint(r) & 0xffff0000u);
  const float l = __fsub_rn(r, m);
  hi = (uint16_t)(__float_as_uint(h) >> 16);
  mid = (uint16_t)(__float_as_uint(m) >> 16);
  lo = (uint16_t)(__float_as_uint(l) >> 16);
}

// Two bf16 values (floats whose low 16 bits are zero) as one register, the
// first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  return __byte_perm(__float_as_uint(first), __float_as_uint(second),
                     0x7632);
}

// Element (query n, dim d) of a bf16 query tile: chunk c = d / 32, and in
// it step s = d % 8 / 4, K-half d % 4 / 2, column 2 (d % 32 / 8) + d % 2
// of the half; each (chunk, step) is two [64 x 8] halves of 16-byte rows,
// 1 KB apart.
__device__ __forceinline__ int w8_q_offset(int n, int d) {
  const int c = d / kTileD, r = d % kTileD;
  return ((((c * 2 + (r & 7) / 4) * 2 + (r & 3) / 2) * kWQT + n) * 8) +
         2 * (r / 8) + (r & 1);
}

// d (+)= A B^T on a warpgroup: A [64 x 16] bf16 from registers (thread
// (g, t) of warp w: rows 16 w + g, + 8, columns 2t, 2t + 1 and 2t + 8, 2t
// + 9, a register a row and column pair, the lower column in the low
// half), B [64 x 16] bf16 from shared memory by ``desc`` (K-major);
// ``acc`` 0 overwrites d.  d as wgmma_tf32's.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// One selector warp's kWQPW queries from q_first (n_mine of them real)
// over a tile's scores (score_s: [64 x kWSStride], rows tile + 0..127),
// under the wide selection: every query's admissible scores (live, at or
// under its bound ``tau_mine``: lane i holds query i's) into registers and
// their least against its k-th at once; then ``release`` (the score tile
// is free for the next tile's scores) and each query with a row under its
// k-th merges them into its list (select_in_registers, staged through
// ``stage``), which publishes the split's slot of ``bound``.
template <typename Release>
__device__ __forceinline__ void w8_select_tile(
    const float* score_s, float* list_d, int* list_i,
    const unsigned char* del, int tile, int row_end, int q_first,
    int n_mine, int k_run, int lane, float tau_mine, float* stage,
    float* bound, int q0, int split, int n_splits, int bound_rank,
    const Release& release) {
  bool live[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int row = tile + lane + 32 * j;
    live[j] = row < row_end && (del == nullptr || del[row] == 0);
  }
  // lane i holds query i's k-th
  const float kth_i = lane < n_mine
                          ? list_d[(q_first + lane) * k_run + k_run - 1]
                          : -CUDART_INF_F;
  unsigned todo = 0;
  float all[kWQPW][kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kWQPW; ++i) {
    const float tau = __shfl_sync(kFull, tau_mine, i);
    float lo = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const float v = score_s[(q_first + i) * kWSStride + lane + 32 * j];
      all[i][j] = live[j] && v <= tau ? v : CUDART_INF_F;
      lo = fminf(lo, all[i][j]);
    }
    if (__any_sync(kFull, lo < __shfl_sync(kFull, kth_i, i))) todo |= 1u << i;
  }
  release();
  while (todo) {                                         // warp-uniform
    const int i = __ffs(todo) - 1;
    todo &= todo - 1;
    const int ql = q_first + i;
    // query i's scores (the registers indexed statically)
    float sc[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      sc[j] = all[0][j];
#pragma unroll
      for (int x = 1; x < kWQPW; ++x)
        if (x == i) sc[j] = all[x][j];
    }
    select_in_registers(list_d + ql * k_run, list_i + ql * k_run, sc,
                        __shfl_sync(kFull, kth_i, i), tile, k_run, lane,
                        stage, bound, (q0 + ql) * n_splits + split,
                        bound_rank);
  }
}

// One block: queries [blockIdx.x 64, + 64) against split blockIdx.y's
// rows, the running lists written to part_d / part_i (as sweep_block).
// ``rows``: the tensor map of the int8 [n_rows, D] rows (box [128 x 32]);
// ``scales``: of the float32 [n_rows] scales (box 128); ``bound`` (f32[B,
// S] or null) and ``bound_rank`` as sweep_block takes them.
__global__ void __launch_bounds__(kWThreads, 1)
sweep_q8_wgmma_kernel(const float* __restrict__ q,
                      const __grid_constant__ CUtensorMap rows,
                      const __grid_constant__ CUtensorMap scales,
                      const unsigned char* __restrict__ del, int B,
                      int n_rows, int D, int k_run, int metric,
                      int rows_per_split, float* __restrict__ part_d,
                      int* __restrict__ part_i, float* bound,
                      int bound_rank) {
  constexpr int kRing = kWQ8Stages;
  constexpr int kBox = kTileN * kTileD;                  // int8 bytes
  static_assert(2 * kRing * 8 <= kWBarBytes, "the mbarriers fit");
  const int n_chunks = (D + kTileD - 1) / kTileD;
  const int q_part = n_chunks * kTileD * kWQT;          // bf16 elements

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint16_t* q_hi = reinterpret_cast<uint16_t*>(ring + kRing * kWQ8StageBytes);
  uint16_t* q_mid = q_hi + q_part;
  uint16_t* q_lo = q_mid + q_part;
  float* score_s = reinterpret_cast<float*>(q_lo + q_part);
  float* qn_s = score_s + kWQT * kWSStride;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(qn_s + kWQT);
  unsigned long long* empty = full + kRing;
  float* stage_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(full) + kWBarBytes);
  float* list_d = stage_s + kWQ8SelectorWarps * kWQ8StageWords;
  int* list_i = reinterpret_cast<int*>(list_d + kWQT * k_run);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kWQT;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_rows, row_begin + rows_per_split);

  // step s of the sweep is (tile s / n_chunks, chunk s % n_chunks), in
  // ring stage s % kRing: its copy, with the tile's scales at its first
  // chunk
  const int total =
      (row_end > row_begin ? (row_end - row_begin + kTileN - 1) / kTileN
                           : 0) * n_chunks;
  const auto copy_step = [&](int s) {
    const int stage = s % kRing, chunk = s % n_chunks;
    const int row = row_begin + s / n_chunks * kTileN;
    unsigned char* dst = ring + stage * kWQ8StageBytes;
    w_mbar_arrive_expect(full + stage,
                         kBox + (chunk == 0 ? kWQ8ScaleBytes : 0));
    w_tensor_copy(dst, &rows, chunk * kTileD, row, full + stage);
    if (chunk == 0) w_tensor_copy_1d(dst + kBox, &scales, row, full + stage);
  };
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      w_mbar_init(full + s, 1);
      w_mbar_init(empty + s, 8);             // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kRing && s < total; ++s) copy_step(s);
  }
  for (int e = tid; e < kWQT * k_run; e += kWThreads) {
    list_d[e] = CUDART_INF_F;
    list_i[e] = -1;
  }
  for (int i = warp; i < kWQT; i += kWThreads / 32) {    // |q|^2
    const int qi = q0 + i;
    float s = 0.f;
    if (qi < B)
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)qi * D + d];
        s = fmaf(v, v, s);
      }
    s = warp_sum(s);
    if (lane == 0) qn_s[i] = s;
  }
  // the query tiles, split once (zero past B and D)
  for (int e = tid; e < q_part; e += kWThreads) {
    const int n = e / (n_chunks * kTileD), d = e % (n_chunks * kTileD);
    const float x =
        q0 + n < B && d < D ? q[(size_t)(q0 + n) * D + d] : 0.f;
    const int at = w8_q_offset(n, d);
    split3_bf16(x, q_hi[at], q_mid[at], q_lo[at]);
  }
  // the tiles are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp < kWSelectorWarp0) {
    // a consumer warpgroup: rows 64 (warp / 4) + 16 (warp % 4) + g, + 8
    const int row0 = 64 * (warp / 4) + 16 * (warp % 4);
    const int g = lane >> 2, t = lane & 3;
    const uint64_t desc_hi = w_desc(q_hi, kWQT * 16, 128);
    const uint64_t desc_mid = w_desc(q_mid, kWQT * 16, 128);
    const uint64_t desc_lo = w_desc(q_lo, kWQT * 16, 128);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    int stage = 0, step = 0;
    unsigned phase = 0;
    int it = 0;
    for (int tile = row_begin; tile < row_end; tile += kTileN, ++it) {
      float pn[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
      for (int c = 0; c < n_chunks; ++c, ++step) {
        const unsigned char* st = ring + stage * kWQ8StageBytes;
        w_mbar_wait(full + stage, phase);
        if (c == 0) {                    // the rows' scales, rounded once
          const float* sc = reinterpret_cast<const float*>(st + kBox);
          sb[0] = round_bf16(sc[row0 + g]);
          sb[1] = round_bf16(sc[row0 + g + 8]);
        }
        // x[h][j]: dim 8t + j of row g + 8 h, widened
        float x[2][8];
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 w = *reinterpret_cast<const uint2*>(
              st + (row0 + g + 8 * h) * kTileD + 8 * t);
          const unsigned ws[2] = {w.x, w.y};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            x[h][j] = widen((int8_t)(ws[j / 4] >> (8 * (j % 4))), sb[h]);
          // step s: a[s][h] dims 8t + 4s, + 1; a[s][2 + h] dims + 2, + 3
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            a[s][h] = pack_bf16(x[h][4 * s], x[h][4 * s + 1]);
            a[s][2 + h] = pack_bf16(x[h][4 * s + 2], x[h][4 * s + 3]);
          }
        }
        w_fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          // (chunk, step)'s query halves: 2 KB a step
          const uint64_t off = (uint64_t)((c * 2 + s) * 2 * kWQT * 16) >> 4;
          wgmma_bf16(acc, a[s], desc_lo + off, c == 0 && s == 0 ? 0 : 1);
          wgmma_bf16(acc, a[s], desc_mid + off, 1);
          wgmma_bf16(acc, a[s], desc_hi + off, 1);
        }
        wgmma_commit();
        // meanwhile: release the stage (the arrival that ends its phase
        // issues its next copy) and add the squares
        __syncwarp();
        if (lane == 0 && w_mbar_arrive_last(empty + stage) &&
            step + kRing < total)
          copy_step(step + kRing);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) pn[h] = fmaf(x[h][j], x[h][j], pn[h]);
        wgmma_wait<0>();
        w_fence_acc(acc);
        if (++stage == kRing) {
          stage = 0;
          phase ^= 1u;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pn[h] += __shfl_xor_sync(kFull, pn[h], 1);
        pn[h] += __shfl_xor_sync(kFull, pn[h], 2);
      }
      // the score tile is free once every selector warp has read the tile
      // before
      if (it > 0) named_bar_sync(kWQ8BarFree, kWBarThreads);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = 8 * i + 2 * t + e;
          const float qn = qn_s[ql];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            score_s[ql * kWSStride + row0 + g + 8 * h] =
                score(acc[4 * i + 2 * h + e], pn[h], qn, metric);
        }
      named_bar_arrive(kWQ8BarFull, kWBarThreads);
    }
  } else {
    // the selector warpgroups: warp w takes queries 8 (w - 8) to + 8
    const int sw = warp - kWSelectorWarp0;
    const int q_first = kWQPW * sw;
    const int n_mine = min(kWQPW, B - q0 - q_first);       // warp-uniform
    float* stage = stage_s + sw * kWQ8StageWords;
    float tau_mine = CUDART_INF_F;
    int it = 0;
    for (int tile = row_begin; tile < row_end; tile += kTileN, ++it) {
      // the bound before the tile, every kWQ8BoundTiles (a stale read is
      // safe: a slot only falls)
      if (kReadBound && bound != nullptr && n_mine > 0 &&
          it % kWQ8BoundTiles == 0)
        tau_mine = read_bound<kWQPW>(bound, q0 + q_first, B, n_splits, lane);
      named_bar_sync(kWQ8BarFull, kWBarThreads);
      // the score tile is free again once this warp's scores are read
      const auto release = [&] {
        if (tile + kTileN < row_end)
          named_bar_arrive(kWQ8BarFree, kWBarThreads);
      };
      // the int8 selection of a tile (it releases the tile)
      if (n_mine > 0)
        w8_select_tile(score_s, list_d, list_i, del, tile, row_end, q_first,
                       n_mine, k_run, lane, tau_mine, stage, bound, q0,
                       split, n_splits, bound_rank, release);
      else
      // the int8 selection of a tile: end
        release();
    }
    for (int i = 0; i < n_mine; ++i) {
      const int ql = q_first + i;
      const size_t base = ((size_t)split * B + q0 + ql) * k_run;
      for (int e = lane; e < k_run; e += 32) {
        part_d[base + e] = list_d[ql * k_run + e];
        part_i[base + e] = list_i[ql * k_run + e];
      }
    }
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The driver's tensor-map encoder, found through the runtime (no link to
// the driver library); null if the driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The Hopper instances' launch and merge: refuses what the rule keeps off
// them (see sweep_wgmma_kernel) and a shared-memory figure other than
// wgmma_smem_bytes.
template <typename T>
int run_topk_wgmma(const float* q, const T* p, const unsigned char* del,
                   int B, int n_rows, int D, int k_run, int metric, int qt,
                   int S, int q_res, int smem_bytes, float* part_d,
                   int* part_i, float* out_d, int* out_i,
                   const float* floor_d, const int* floor_i,
                   void* stream_ptr) {
  if (B <= 0 || n_rows < 0 || D <= 0 || D > kWMaxD || k_run < 1 ||
      k_run >= kWMaxK || S < 1 || S > kMaxSplits || qt != kWQT || !q_res ||
      (metric != kMetricL2 && metric != kMetricCosine) ||
      floor_d != nullptr || floor_i != nullptr ||
      (D * sizeof(T)) % 16 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes<T>(k_run, D);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the rows as a [n_rows, D] tensor (one row at least: an empty corpus
  // launches blocks that copy nothing)
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)max(n_rows, 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {kTileD, kTileN}, ones[2] = {1, 1};
  if (encode(&map,
             sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_UINT16,
             2, const_cast<T*>(p), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(sweep_wgmma_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split =
      ceil_div(ceil_div(n_rows, S), kTileN) * kTileN;
  sweep_wgmma_kernel<T><<<dim3(ceil_div(B, kWQT), S), kWThreads, smem,
                          stream>>>(q, map, del, B, n_rows, D, k_run, metric,
                                    rows_per_split, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<ceil_div(B, kMergeWarps), kMergeWarps * 32, 0, stream>>>(
      part_d, part_i, B, S, k_run, metric, out_d, out_i, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The int8 Hopper instance's launch and merge: refuses what the rule keeps
// off it (see sweep_q8_wgmma_kernel), a bound rank with S j < k_run and a
// shared-memory figure other than q8_wgmma_smem_bytes.
int run_topk_q8_wgmma(const float* q, const int8_t* p, const float* scale,
                      const unsigned char* del, int B, int n_rows, int D,
                      int k_run, int metric, int qt, int S, int q_res,
                      int smem_bytes, float* part_d, int* part_i,
                      float* out_d, int* out_i, const float* floor_d,
                      const int* floor_i, float* bound, int bound_rank,
                      void* stream_ptr) {
  if (B <= 0 || n_rows < 0 || D <= 0 || D > kWMaxD || k_run < 1 ||
      k_run > kWQ8MaxK || S < 1 || S > kMaxSplits || qt != kWQT || !q_res ||
      (metric != kMetricL2 && metric != kMetricCosine) ||
      floor_d != nullptr || floor_i != nullptr || scale == nullptr ||
      D % 16 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scale) % 16 != 0 ||
      (bound != nullptr && (bound_rank < 1 || bound_rank > k_run ||
                            (long long)S * bound_rank < k_run)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = q8_wgmma_smem_bytes(k_run, D);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the rows as a [n_rows, D] tensor and the scales as a [n_rows] one (one
  // row at least: an empty corpus launches blocks that copy nothing)
  const cuuint64_t n = (cuuint64_t)max(n_rows, 1);
  CUtensorMap rows, scales;
  const cuuint64_t dims[2] = {(cuuint64_t)D, n};
  const cuuint64_t strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {kTileD, kTileN}, ones[2] = {1, 1};
  const cuuint32_t scale_box[1] = {kTileN};
  if (encode(&rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
             const_cast<float*>(scale), &n, strides, scale_box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(sweep_q8_wgmma_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split =
      ceil_div(ceil_div(n_rows, S), kTileN) * kTileN;
  sweep_q8_wgmma_kernel<<<dim3(ceil_div(B, kWQT), S), kWThreads, smem,
                          stream>>>(q, rows, scales, del, B, n_rows, D,
                                    k_run, metric, rows_per_split, part_d,
                                    part_i, bound, bound_rank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<ceil_div(B, kMergeWarps), kMergeWarps * 32, 0, stream>>>(
      part_d, part_i, B, S, k_run, metric, out_d, out_i, nullptr, nullptr);
  return (int)cudaGetLastError();
}

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

// The Hopper instances (sweep_wgmma_kernel): arguments as
// bruteforce_topk's / _bf16's, for the shapes ops/cuda_bruteforce's rule
// sends them (QT = 64, resident queries, k_run < 64, D <= 128, 16-byte
// rows and base, L2 or cosine, no floor); anything else is refused.
int bruteforce_topk_wgmma(const float* q, const float* p,
                          const unsigned char* del, int B, int n_rows, int D,
                          int k_run, int metric, int qt, int S, int q_res,
                          int smem_bytes, float* part_d, int* part_i,
                          float* out_d, int* out_i, float* floor_d,
                          int* floor_i, void* stream_ptr) {
  return run_topk_wgmma(q, p, del, B, n_rows, D, k_run, metric, qt, S, q_res,
                        smem_bytes, part_d, part_i, out_d, out_i, floor_d,
                        floor_i, stream_ptr);
}

int bruteforce_topk_bf16_wgmma(const float* q, const void* p,
                               const unsigned char* del, int B, int n_rows,
                               int D, int k_run, int metric, int qt, int S,
                               int q_res, int smem_bytes, float* part_d,
                               int* part_i, float* out_d, int* out_i,
                               float* floor_d, int* floor_i,
                               void* stream_ptr) {
  return run_topk_wgmma(q, static_cast<const uint16_t*>(p), del, B, n_rows,
                        D, k_run, metric, qt, S, q_res, smem_bytes, part_d,
                        part_i, out_d, out_i, floor_d, floor_i, stream_ptr);
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

// The int8 Hopper instance (sweep_q8_wgmma_kernel): arguments as
// bruteforce_topk_q8's, for the shapes ops/cuda_bruteforce's rule sends it
// (QT = 64, resident queries, k_run <= 256, D <= 128 with D % 16 == 0,
// 16-byte aligned rows and scales, L2 or cosine, no floor); anything else
// is refused.
int bruteforce_topk_q8_wgmma(const float* q, const void* p,
                             const float* scale, const unsigned char* del,
                             int B, int n_rows, int D, int k_run, int metric,
                             int qt, int S, int q_res, int smem_bytes,
                             float* part_d, int* part_i, float* out_d,
                             int* out_i, float* floor_d, int* floor_i,
                             float* bound, int bound_rank, void* stream_ptr) {
  return run_topk_q8_wgmma(q, static_cast<const int8_t*>(p), scale, del, B,
                           n_rows, D, k_run, metric, qt, S, q_res,
                           smem_bytes, part_d, part_i, out_d, out_i, floor_d,
                           floor_i, bound, bound_rank, stream_ptr);
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
