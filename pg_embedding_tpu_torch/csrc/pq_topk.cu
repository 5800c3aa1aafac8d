// The compressed sweep's coarse pool for NVIDIA Hopper (sm_90a): PQ codes
// decoded through the codebook in shared memory, scored on the bf16 tensor
// cores, filtered against a bound the splits share, then selected.
//
// Replaces: pg_embedding_tpu/ops/pq_sweep.py::_pq_pool_impl (its
// lax.fori_loop over chunks of decoded rows and its running top_k), the
// pool of search(mode="sweep_pq").  Rows are PQ codes u8[N, G] (G bytes a
// row where float32 rows take 4 D); a row element is bf16(codebook[d /
// sub, code[r, d / sub], d % sub]), sub = D / G, the JAX package's and the
// port's decode rounded once to bf16.  The function is the one the port's
// twin (ops/pq_sweep._pq_pool_plain) computes: each query's ``k_run``
// least rows by (score, id), rows >= n_valid and tombstones never taken,
// ascending, L2 sqrt'd; a page floor admits only what follows it.
//
// What bounds it (1M x 128-d, B = 1024): the products, 2 B N D = 268
// GFLOP in three bf16 passes (the query split into three bf16 parts) at
// 989 TFLOP/s, 0.795 ms; the codes are 32 MB at G = 32.  Manhattan: 2 B N
// D float32 operations on the CUDA cores at 67 TFLOP/s, 4.0 ms.
//
// The design, against what held the first PQ kernel (a row source of the
// exact sweep's template) back: lists in shared memory that set the query
// tile (16 queries past a pool of 256, so each row was decoded 64 times a
// call), a conflicting table read, two TF32 passes.
//  * One query tile of 128 for every pool, no lists in shared memory.
//    The sweep (pq_sweep_kernel, a block per (split, query tile), a
//    query tile's splits side by side) scores a [128 x 128] tile and
//    appends each (query, row) that scores at most the query's bound to
//    the (query, split) segment of a candidate buffer in device memory
//    (int2 {score bits, id}; a shared-memory counter a query).  The bound
//    is shared by the splits: each (query, split) keeps the 32 least
//    scores of the rows it stored (a sorted list across a warp's lanes in
//    shared memory; a tile's rows that beat the list's last are staged and
//    merged after the tile, or, past 32 of them, read back from the
//    segment), publishes the list's j-th to its slot of bound f32[B, S]
//    when it fell, and every kRefresh tiles reads the S slots: lane l
//    folds slots l, l + 32, ... into their largest (+inf while any is
//    unpublished), and the bound falls to the P-th least fold, P =
//    ceil(k_run / j).  Each finite fold names j rows of its own splits at
//    or under it, so P folds name k_run rows: a row scoring past the bound
//    is in no pool, and one scoring equal may be (a lower id), hence <=.
//    The wrapper takes j so that P is about half the folds; when k_run <=
//    32 the split's own k_run-th bounds it too.  A slot only falls; a
//    stale read is larger, still safe.  A seeding launch sweeps the first
//    kSeedTiles tiles of every split first, so every slot is published
//    before the sweep proper starts: a block that starts a wave after its
//    query tile's other splits (whose slots would be +inf) admits no more
//    than a bounded block does.  The select (pq_select_kernel, a block a
//    query) takes the rows of the query's segments that score at most the
//    final bound, finds the
//    k_run-th least (score, id) key by a radix select over the 64-bit key
//    (ordered score bits, id; eight 8-bit passes at most, stopping once a
//    bin holds exactly the rows still needed), gathers the k_run keys and
//    sorts them bitonically.  A segment holds ``cap`` rows; one that
//    overflows drops none silently: the counts go on counting, and the
//    wrapper runs the call again with the bound as the first run left it
//    and cap = the largest count, under which no segment can take more
//    rows than it did (every row it admits scored at most a bound no
//    larger than the first run's, which admitted it too).
//  * Each row decoded once a query tile (B / 128 times a call) into a
//    [128 x 64] bf16 tile in shared memory; decoded rows never reach
//    device memory.  The ring stages a step's (row tile, 64 dims) code
//    windows, the codebook table's chunk of 32 bf16 pairs x 256 codes and
//    the query chunk (float32) by cp.async.
//  * No bank conflicts in the decode: the table chunk is laid out [code]
//    [pair], so lane p of a warp decodes pair p (dims 2p, 2p + 1) of one
//    row and reads word 32 code + p, bank p, whatever the codes.  The code
//    bytes of a row lie in one window of at most 68 bytes (all lanes read
//    the same row).
//  * The products on the bf16 tensor cores: mma.sync m16n8k16 with the
//    decoded tile as B (a conflict-free 32-bit read a fragment register)
//    and the query split in registers into three bf16 parts by truncation
//    (x = hi + mid + lo exactly), three passes, float32 accumulation
//    into a partial sum a step and m16 tile (the step's lo and mid
//    passes, then its hi pass), added to the tile's sums rounded to
//    nearest: the tensor cores truncate each mma's sum, and summed in one
//    accumulator the scores carried several times the twin's error.
//    wgmma would need the decoded tile in its swizzled shared-memory
//    layout and a warpgroup's accumulators; mma.sync was kept for this
//    first redesign, whose time the selection and decode share with it.
//  * Manhattan: |q - p| summed on the CUDA cores over the same decoded
//    tile into the accumulators' (query, row) slots, dims ascending, each
//    difference and sum rounded on its own.
// Every score rounds each operation as the twin's torch ops do (no FMA
// contraction in the epilogue), so integer codebooks give the twin's
// scores bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 128;                      // queries a block
constexpr int kTileN = 128;                   // rows a tile
constexpr int kStepD = 64;                    // dims a ring step
constexpr int kPairs = kStepD / 2;            // a lane a bf16 pair
constexpr int kCodes = 256;
constexpr int kStages = 2;
constexpr int kCS = 80;                       // code window row stride (bytes)
constexpr int kQS = kStepD + 8;               // query chunk stride (floats)
constexpr int kDW = kPairs + 4;               // decoded tile stride (words)
constexpr int kJ = 32;                        // a split's bound list
// tiles between reads of the shared slots (sweep_probe's pq-refresh-N);
// in between a query's bound takes only its own list's fall
constexpr int kRefresh = 8;
// tiles a split sweeps in the seeding launch, which fills the slots
// before the sweep proper (0: no seeding; sweep_probe's pq-seed-N)
constexpr int kSeedTiles = 2;
constexpr int kWN = 2;                        // warps across the rows
constexpr int kMT = 2;                        // m16 tiles a warp (32 queries)
constexpr int kNT = 8;                        // n8 tiles a warp (64 rows)
constexpr int kQPW = kQT / kWarps;            // queries a warp bounds
constexpr int kMaxSplits = 128;
constexpr int kMaxK = 1024;
constexpr int kSmemLimit = 232448;
constexpr int kSelectThreads = 256;
constexpr int kMetricL2 = 0;
constexpr int kMetricCosine = 1;
constexpr int kMetricManhattan = 2;
constexpr unsigned kFull = 0xffffffffu;

// a ring stage: code windows, dim offsets, table chunk, query chunk
constexpr int kCodeBytes = kTileN * kCS;
constexpr int kOffBytes = kStepD;
constexpr int kTableBytes = kCodes * kPairs * 4;
constexpr int kQBytes = kQT * kQS * 4;
constexpr int kStageBytes = kCodeBytes + kOffBytes + kTableBytes + kQBytes;
// then the decoded tile, the bound lists and their staged rows, nine
// words a query (|q|^2, the bound, the floor's score and id, the appended
// count at the tile's start and now, the published slot, the list's last,
// the staged count) and two a row (|p|^2, dead)
constexpr int kSmemBytes = kStages * kStageBytes + kTileN * kDW * 4 +
                           2 * kQT * kJ * 4 + 9 * kQT * 4 + 2 * kTileN * 4;
static_assert(kSmemBytes <= kSmemLimit, "shared memory");

// Phase clocks of the instrumented build (-DPG_PROFILE): thread 0 of each
// sweep block sums its laps (each phase but the mma's ends at a block
// barrier, so a lap is the block's time in it) and adds them to
// g_pq_prof at the end, then its tiles and 1; thread 0 of each select
// block adds its cycles.
enum { kLapCopy, kLapDecode, kLapMma, kLapFilter, kLapBound, kLapClose,
       kLaps };
#ifdef PG_PROFILE
// the laps' cycles, tiles, sweep blocks, select cycles, select blocks
__device__ unsigned long long g_pq_prof[kLaps + 4];
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
  __device__ void flush(int tiles) {
    for (int i = 0; i < kLaps; ++i)
      atomicAdd(&g_pq_prof[i], (unsigned long long)acc[i]);
    atomicAdd(&g_pq_prof[kLaps], (unsigned long long)tiles);
    atomicAdd(&g_pq_prof[kLaps + 1], 1ull);
  }
};
#else
struct Laps {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void flush(int) {}
};
#endif

// (d, id) order; id -1 (an empty slot) sorts after every real id
__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && (unsigned)ia < (unsigned)ib);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The warp's sums of 16 values a lane, v[i] summed over the 32 lanes, by
// halving exchanges (16 shuffles, not 80): lanes 2 i and 2 i + 1 return
// sum i.
__device__ __forceinline__ float sum16(float (&v)[16], int lane) {
  float a[8], b[4], c[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a[j] = (h4 ? v[j + 8] : v[j]) +
           __shfl_xor_sync(kFull, h4 ? v[j] : v[j + 8], 16);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = (h3 ? a[j + 4] : a[j]) +
           __shfl_xor_sync(kFull, h3 ? a[j] : a[j + 4], 8);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    c[j] = (h2 ? b[j + 2] : b[j]) +
           __shfl_xor_sync(kFull, h2 ? b[j] : b[j + 2], 4);
  float d = (h1 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h1 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(kFull, d, 1);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// x = hi + mid + lo exactly, each part a bf16 value (its float32's top 16
// bits) cut by truncation: hi keeps x's top 8 significant bits, the rest
// (at most 16 bits) splits into mid's 8 and lo's.  Two elements a call,
// packed as an mma fragment register: the first in the low half.
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const float h0 = __uint_as_float(__float_as_uint(x.x) & 0xffff0000u);
  const float h1 = __uint_as_float(__float_as_uint(x.y) & 0xffff0000u);
  const float r0 = __fsub_rn(x.x, h0), r1 = __fsub_rn(x.y, h1);
  const float m0 = __uint_as_float(__float_as_uint(r0) & 0xffff0000u);
  const float m1 = __uint_as_float(__float_as_uint(r1) & 0xffff0000u);
  const float l0 = __fsub_rn(r0, m0), l1 = __fsub_rn(r1, m1);
  hi = __byte_perm(__float_as_uint(h0), __float_as_uint(h1), 0x7632);
  mid = __byte_perm(__float_as_uint(m0), __float_as_uint(m1), 0x7632);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// The hi part alone (split3's first)
__device__ __forceinline__ uint32_t split_hi(float2 x) {
  return __byte_perm(__float_as_uint(x.x), __float_as_uint(x.y), 0x7632);
}

// c += a.b, m16n8k16, bf16 inputs, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Relaxed loads and stores of the shared bound at device scope (served by
// L2, no stale L1 line; volatile, so no tile's read is hoisted).
__device__ __forceinline__ float load_bound(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_bound(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;\n" ::"l"(p), "f"(v)
               : "memory");
}

// The score from the accumulated product, each operation rounded on its
// own as the port's pairwise_dist rounds it (Manhattan's accumulators are
// the score).
__device__ __forceinline__ float score_rn(float dot, float pn, float qn,
                                          int metric) {
  if (metric == kMetricManhattan) return dot;
  return metric == kMetricL2
             ? fmaxf(__fsub_rn(__fadd_rn(pn, qn), __fmul_rn(2.f, dot)), 0.f)
             : __fsub_rn(1.f, __fmul_rn(dot, rsqrtf(fmaxf(__fmul_rn(pn, qn),
                                                          1e-30f))));
}

// The step at (tile, d0) into ring stage ``stage``: each row's codes of
// the groups dims [d0, d0 + 64) fall in, bytes [w0, g_end) of the row with
// w0 = d0 / sub rounded down to a whole word (at most 68 bytes; zero past
// row_end), by 4-byte cp.async when ``vec_c`` (G % 4 == 0, aligned base),
// else by bytes; each dim's offset d / sub - w0 in the staged window (0
// past D, where the table is 0); the table's chunk d0 / 64 (16-byte
// cp.async); the query chunk [128 x 64] (zero past B and D; 16-byte
// copies when ``vec_q``).
__device__ __forceinline__ void load_step(
    const float* __restrict__ q, const uint8_t* __restrict__ codes,
    const uint32_t* __restrict__ table, unsigned char* stage, int tile,
    int row_end, int d0, int q0, int B, int D, int G, bool vec_q, bool vec_c,
    int tid) {
  uint8_t* codes_s = stage;
  unsigned char* off_s = stage + kCodeBytes;
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(stage + kCodeBytes +
                                                kOffBytes);
  float* q_s = reinterpret_cast<float*>(stage + kCodeBytes + kOffBytes +
                                        kTableBytes);
  const int sub = D / G;
  const int w0 = (d0 / sub) & ~3;
  const int nb = min(G, (min(d0 + kStepD, D) - 1) / sub + 1) - w0;
  if (vec_c) {
    const int nw = (nb + 3) >> 2;
    for (int e = tid; e < kTileN * nw; e += kThreads) {
      const int r = e / nw, c = 4 * (e - r * nw);
      const bool in = tile + r < row_end;
      cp_async4(codes_s + r * kCS + c,
                in ? codes + (size_t)(tile + r) * G + w0 + c : codes, in);
    }
  } else {
    for (int e = tid; e < kTileN * nb; e += kThreads) {
      const int r = e / nb, c = e - r * nb;
      codes_s[r * kCS + c] =
          tile + r < row_end ? codes[(size_t)(tile + r) * G + w0 + c] : 0;
    }
  }
  if (tid < kStepD)
    off_s[tid] = d0 + tid < D ? (unsigned char)((d0 + tid) / sub - w0) : 0;
  const uint32_t* chunk = table + (size_t)(d0 / kStepD) * kCodes * kPairs;
  for (int e = tid; e < kCodes * kPairs / 4; e += kThreads)
    cp_async16(tab_s + 4 * e, chunk + 4 * e, true);
  if (vec_q) {
    for (int e = tid; e < kQT * kStepD / 4; e += kThreads) {
      const int r = e / (kStepD / 4), c = 4 * (e % (kStepD / 4));
      const bool in = q0 + r < B && d0 + c < D;
      cp_async16(q_s + r * kQS + c, in ? q + (size_t)(q0 + r) * D + d0 + c : q,
                 in);
    }
  } else {
    for (int e = tid; e < kQT * kStepD; e += kThreads) {
      const int r = e / kStepD, c = e % kStepD;
      q_s[r * kQS + c] = q0 + r < B && d0 + c < D
                             ? q[(size_t)(q0 + r) * D + d0 + c]
                             : 0.f;
    }
  }
}

// Lane l's fold of a query's S slots: the largest of slots l, l + 32, ...
// (+inf for a lane with none).  A finite fold names j stored rows.
__device__ __forceinline__ float fold_slots(const float* slots, int S,
                                            int lane) {
  float v = lane < S ? -CUDART_INF_F : CUDART_INF_F;
  for (int s = lane; s < S; s += 32) v = fmaxf(v, load_bound(slots + s));
  return v;
}

// The P-th least of the warp's 32 folds (P = ceil(k_run / j) <= 32): at
// or over k_run stored rows, the least such bound the folds give.
__device__ __forceinline__ float pth_fold(float v, int P, int lane) {
  if (P == 1) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
  if (P == 32) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
  for (int k = 2; k <= 32; k <<= 1)
    for (int o = k >> 1; o > 0; o >>= 1) {
      const float p = __shfl_xor_sync(kFull, v, o);
      v = (((lane & o) == 0) == ((lane & k) == 0)) ? fminf(v, p)
                                                   : fmaxf(v, p);
    }
  return __shfl_sync(kFull, v, P - 1);
}

// A sorted warp list of 32 scores (lane l: the l-th least) takes the 32
// least of itself and ``v`` (one score a lane, any order): v sorted by a
// bitonic network, slot l the lesser of list l and v 31 - l (a bitonic
// sequence of the 32 least), sorted again.
__device__ __forceinline__ float merge32(float list, float v, int lane) {
  for (int k = 2; k <= 32; k <<= 1)
    for (int o = k >> 1; o > 0; o >>= 1) {
      const float p = __shfl_xor_sync(kFull, v, o);
      v = (((lane & o) == 0) == ((lane & k) == 0)) ? fminf(v, p)
                                                   : fmaxf(v, p);
    }
  list = fminf(list, __shfl_sync(kFull, v, 31 - lane));
  for (int o = 16; o > 0; o >>= 1) {
    const float p = __shfl_xor_sync(kFull, list, o);
    list = (lane & o) == 0 ? fminf(list, p) : fmaxf(list, p);
  }
  return list;
}

// Entry j of a thread's 16 (j runtime, the registers indexed statically)
__device__ __forceinline__ float pick16(const float (&v)[16], int j) {
  float r = v[0];
#pragma unroll
  for (int x = 1; x < 16; ++x)
    if (x == j) r = v[x];
  return r;
}

// Insert score v into a sorted warp list (lane l: the l-th least): the
// lanes past its place shift up one.
__device__ __forceinline__ float insert32(float list, float v, int lane) {
  const int pos = __popc(__ballot_sync(kFull, list <= v));
  const float up = __shfl_up_sync(kFull, list, 1);
  return lane > pos ? up : lane == pos ? v : list;
}

// One block: queries [blockIdx.y 128, + 128) against split blockIdx.x's
// rows.  Appends (score, id) of each admitted row to buf's (query, split)
// segment of ``cap`` entries (past cap only counted) and writes each
// query's count to counts[q, split].  ``bound`` f32[B, S] at rank
// ``bound_rank`` j (null and 0: no bound shared).  ``tile_limit``: the
// tiles of its split a block sweeps at most (the seeding launch's).
// ``kL1``: Manhattan on the CUDA cores.
template <bool kL1>
__global__ void __launch_bounds__(kThreads, 1)
pq_sweep_kernel(const float* __restrict__ q, const uint8_t* __restrict__ codes,
                const uint32_t* __restrict__ table,
                const unsigned char* __restrict__ del, int B, int n_rows,
                int D, int G, bool vec_q, bool vec_c, int k_run, int metric,
                int rows_per_split, const float* __restrict__ floor_d,
                const int* __restrict__ floor_i, int2* __restrict__ buf,
                int cap, int* __restrict__ counts, float* bound,
                int bound_rank, int tile_limit) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem + kStages * kStageBytes);
  float* jl = reinterpret_cast<float*>(dec + kTileN * kDW);   // [QT][kJ]
  float* stage_s = jl + kQT * kJ;                             // [QT][kJ]
  float* qn_s = stage_s + kQT * kJ;
  float* tau_s = qn_s + kQT;
  float* fld_s = tau_s + kQT;
  int* fli_s = reinterpret_cast<int*>(fld_s + kQT);
  int* cnt0_s = fli_s + kQT;
  int* cnt_s = cnt0_s + kQT;
  float* slot_s = reinterpret_cast<float*>(cnt_s + kQT);
  float* last_s = slot_s + kQT;
  int* staged_s = reinterpret_cast<int*>(last_s + kQT);
  float* pn_s = reinterpret_cast<float*>(staged_s + kQT);
  int* dead_s = reinterpret_cast<int*>(pn_s + kTileN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m_base = (warp / kWN) * (kMT * 16);
  const int n_base = (warp % kWN) * (kNT * 8);
  const int split = blockIdx.x, S = gridDim.x;
  const int q0 = blockIdx.y * kQT;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_rows, row_begin + rows_per_split);
  const bool own = k_run <= kJ;            // the own list bounds alone
  // folds the shared bound takes
  const int P = bound_rank > 0 ? (k_run + bound_rank - 1) / bound_rank : 0;

  if (tid < kQT) {
    const int qi = q0 + tid;
    fld_s[tid] = floor_d != nullptr && qi < B ? floor_d[qi] : -CUDART_INF_F;
    fli_s[tid] = floor_i != nullptr && qi < B ? floor_i[qi] : -1;
    cnt0_s[tid] = cnt_s[tid] = staged_s[tid] = 0;
    slot_s[tid] = bound != nullptr && qi < B ? bound[(size_t)qi * S + split]
                                             : CUDART_INF_F;
    last_s[tid] = CUDART_INF_F;
  }
  for (int e = tid; e < kQT * kJ; e += kThreads) jl[e] = CUDART_INF_F;
  // each warp's queries: |q|^2 and the first tile's bound (no query past
  // B is admitted: its bound is -inf)
  for (int i = 0; i < kQPW; ++i) {
    const int ql = warp * kQPW + i, qi = q0 + ql;
    float s = 0.f;
    if (!kL1 && qi < B)
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)qi * D + d];
        s = fmaf(v, v, s);
      }
    s = warp_sum(s);
    const float tau =
        qi >= B ? -CUDART_INF_F
        : bound != nullptr
            ? pth_fold(fold_slots(bound + (size_t)qi * S, S, lane), P, lane)
            : CUDART_INF_F;
    if (lane == 0) {
      qn_s[ql] = s;
      tau_s[ql] = tau;
    }
  }
  __syncthreads();

  Laps laps;
  if (tid == 0) laps.start();
  // step s is (tile s / n_chunks, 64-dim chunk s % n_chunks), in ring stage
  // s & 1
  const int n_chunks = (D + kStepD - 1) / kStepD;
  const int n_tiles = min(
      tile_limit,
      row_end > row_begin ? (row_end - row_begin + kTileN - 1) / kTileN : 0);
  const int total = n_tiles * n_chunks;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  if (total > 0)
    load_step(q, codes, table, smem, row_begin, row_end, 0, q0, B, D, G,
              vec_q, vec_c, tid);
  cp_async_commit();
  int tile = row_begin, chunk = 0;
  for (int s = 0; s < total; ++s) {
    const bool last = chunk == n_chunks - 1;
    // stage (s + 1) & 1 was last read in step s - 1, before its closing
    // barrier
    if (s + 1 < total)
      load_step(q, codes, table, smem + ((s + 1) & 1) * kStageBytes,
                last ? tile + kTileN : tile, row_end,
                last ? 0 : (chunk + 1) * kStepD, q0, B, D, G, vec_q, vec_c,
                tid);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (tid == 0) laps.lap(kLapCopy);
    unsigned char* stage = smem + (s & 1) * kStageBytes;
    const uint8_t* codes_s = stage;
    const unsigned char* off_s = stage + kCodeBytes;
    const uint32_t* tab = reinterpret_cast<const uint32_t*>(
        stage + kCodeBytes + kOffBytes);
    const float* q_s = reinterpret_cast<const float*>(
        stage + kCodeBytes + kOffBytes + kTableBytes);

    // decode: warp w takes rows w, w + 8, ...; lane p pair p of the chunk
    // (a second table read where the pair straddles two groups); the
    // chunk's |p|^2 parts summed across the lanes (sum16) and added to
    // the row's sum in shared memory, so nothing is held in registers
    // across the step's mma's
    {
      const int o0 = off_s[2 * lane], o1 = off_s[2 * lane + 1];
      float rowsq[kTileN / kWarps];   // a lane's |p|^2 part of each row
#pragma unroll
      for (int i = 0; i < kTileN / kWarps; ++i) {
        const int r = warp + kWarps * i;
        uint32_t w = tab[codes_s[r * kCS + o0] * kPairs + lane];
        if (o1 != o0)
          w = (w & 0xffffu) |
              (tab[codes_s[r * kCS + o1] * kPairs + lane] & 0xffff0000u);
        dec[r * kDW + lane] = w;
        const float v0 = lo_bf16(w), v1 = hi_bf16(w);
        rowsq[i] = fmaf(v1, v1, __fmul_rn(v0, v0));
      }
      if (!kL1) {
        const float sq = sum16(rowsq, lane);
        float* pn = pn_s + warp + kWarps * (lane >> 1);
        if ((lane & 1) == 0) *pn = chunk == 0 ? sq : __fadd_rn(*pn, sq);
      }
      if (chunk == 0 && tid < kTileN) {
        const int row = tile + tid;
        dead_s[tid] = row >= row_end || (del != nullptr && del[row] != 0);
      }
    }
    __syncthreads();
    if (tid == 0) laps.lap(kLapDecode);

    if constexpr (kL1) {
#pragma unroll 2
      for (int k = 0; k < kStepD; k += 2) {
        float2 qv[kMT][2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float* qa = q_s + (m_base + mt * 16 + g) * kQS + k;
          qv[mt][0] = *reinterpret_cast<const float2*>(qa);
          qv[mt][1] = *reinterpret_cast<const float2*>(qa + 8 * kQS);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t* pb = dec + (n_base + nt * 8 + 2 * t) * kDW + k / 2;
          const uint32_t w[2] = {pb[0], pb[kDW]};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float2 x = qv[mt][c >> 1];
              float a = acc[mt][nt][c];
              a = __fadd_rn(a, fabsf(__fsub_rn(x.x, lo_bf16(w[c & 1]))));
              a = __fadd_rn(a, fabsf(__fsub_rn(x.y, hi_bf16(w[c & 1]))));
              acc[mt][nt][c] = a;
            }
        }
      }
    } else {
      // An m16 tile's products of the step go to a partial sum of their
      // own (the step's lo and mid passes, then its hi pass), which is
      // then added to the tile's sums rounded to nearest.  The tensor
      // cores' float32 accumulation truncates each mma's sum to the
      // accumulator's precision, so the small parts go in while the sum
      // is small, and no mma adds into the sum of the steps before.  One
      // m16 tile at a time keeps the partial at 32 registers; the B
      // fragments are read once an m16 tile.
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float part[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[nt][c] = 0.f;
#pragma unroll
        for (int pass = 0; pass < 2; ++pass)
#pragma unroll
          for (int k0 = 0; k0 < kStepD; k0 += 16) {
            const float* qa = q_s + (m_base + mt * 16 + g) * kQS + k0 + 2 * t;
            const float2 x[4] = {
                *reinterpret_cast<const float2*>(qa),
                *reinterpret_cast<const float2*>(qa + 8 * kQS),
                *reinterpret_cast<const float2*>(qa + 8),
                *reinterpret_cast<const float2*>(qa + 8 * kQS + 8)};
            uint32_t a0[4], a1[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (pass == 0) {
                uint32_t hi;
                split3(x[j], hi, a1[j], a0[j]);
              } else {
                a0[j] = split_hi(x[j]);
              }
            }
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const uint32_t* pb =
                  dec + (n_base + nt * 8 + g) * kDW + k0 / 2 + t;
              const uint32_t b0 = pb[0], b1 = pb[4];
              mma_bf16(part[nt], a0, b0, b1);
              if (pass == 0) mma_bf16(part[nt], a1, b0, b1);
            }
          }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mt][nt][c] = __fadd_rn(acc[mt][nt][c], part[nt][c]);
      }
    }

    if (tid == 0) laps.lap(kLapMma);
    if (last) {
      // the filter: every (query, row) of the tile at or under its
      // query's bound and after its floor goes to the query's segment.
      // C fragment (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); the rows'
      // |p|^2 and tombstones read once
      float pn_r[kNT][2];
      unsigned dead_r = 0;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = n_base + nt * 8 + 2 * t + c;
          pn_r[nt][c] = kL1 ? 0.f : pn_s[r];
          dead_r |= (unsigned)(dead_s[r] != 0) << (2 * nt + c);
        }
      const bool floored = floor_d != nullptr;
      // Each of the thread's 4 queries: its 16 scores and a mask of the
      // admitted, then one loop over the mask (its code once a query, not
      // once a slot: the tile's loop must fit the instruction cache)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ql = m_base + mt * 16 + g + 8 * h;
          const float qn = qn_s[ql], tau = tau_s[ql], fd = fld_s[ql];
          const int fi = fli_s[ql];
          float sc[16];
          unsigned admit = 0;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = 2 * nt + c;
              sc[j] = kL1 ? acc[mt][nt][2 * h + c]
                          : score_rn(acc[mt][nt][2 * h + c], pn_r[nt][c], qn,
                                     metric);
              acc[mt][nt][2 * h + c] = 0.f;
              const int id = tile + n_base + nt * 8 + 2 * t + c;
              admit |= (unsigned)(sc[j] <= tau && !((dead_r >> j) & 1u) &&
                                  (!floored || lex_less(fd, fi, sc[j], id)))
                       << j;
            }
          if (admit == 0) continue;
          int2* seg = buf + ((size_t)(q0 + ql) * S + split) * cap;
          const float last_l = last_s[ql];
          do {
            const int j = __ffs(admit) - 1;
            admit &= admit - 1;
            const float v = pick16(sc, j);
            const int id = tile + n_base + (j >> 1) * 8 + 2 * t + (j & 1);
            const int at = atomicAdd(&cnt_s[ql], 1);
            if (at < cap) seg[at] = make_int2(__float_as_int(v), id);
            // a row that beats the list's last: staged for the list (past
            // 32 a tile, dropped: the list need only hold real rows)
            if (v < last_l) {
              const int k = atomicAdd(&staged_s[ql], 1);
              if (k < kJ) stage_s[ql * kJ + k] = v;
            }
          } while (admit);
        }
      __syncthreads();
      if (tid == 0) laps.lap(kLapFilter);
      // the bound: each warp's queries that staged rows take them into
      // their lists (past 32 of them, the tile's stored rows, read back),
      // publish the list's j-th when it fell and lower their bound to the
      // own list's k_run-th; every kRefresh tiles each warp reads its
      // queries' S slots at once and lowers their bounds to the folds'
      if (bound != nullptr || own) {
        // the warp's queries that staged rows
        unsigned work = __ballot_sync(
            kFull, lane < kQPW && staged_s[warp * kQPW + lane] > 0);
        while (work) {
          const int i = __ffs(work) - 1;
          work &= work - 1;
          const int ql = warp * kQPW + i;
          const int n = staged_s[ql];                     // warp-uniform
          float list = jl[ql * kJ + lane];
          if (n <= 4) {
            // a few rows: one by one
            for (int e = 0; e < n; ++e)
              list = insert32(list, stage_s[ql * kJ + e], lane);
          } else if (n > kJ) {
            const int2* seg = buf + ((size_t)(q0 + ql) * S + split) * cap;
            const int to = min(cnt_s[ql], cap);
            for (int e = cnt0_s[ql]; e < to; e += 32) {
              const float v = e + lane < to
                                  ? __int_as_float(seg[e + lane].x)
                                  : CUDART_INF_F;
              if (__any_sync(kFull, v < __shfl_sync(kFull, list, kJ - 1)))
                list = merge32(list, v, lane);
            }
          } else {
            list = merge32(list, lane < n ? stage_s[ql * kJ + lane]
                                          : CUDART_INF_F, lane);
          }
          jl[ql * kJ + lane] = list;
          const float last = __shfl_sync(kFull, list, kJ - 1);
          const float own_k = own ? __shfl_sync(kFull, list, k_run - 1)
                                  : CUDART_INF_F;
          const float now = bound_rank > 0
                                ? __shfl_sync(kFull, list, bound_rank - 1)
                                : CUDART_INF_F;
          if (lane == 0) {
            staged_s[ql] = 0;
            last_s[ql] = last;
            if (q0 + ql < B) {
              tau_s[ql] = fminf(tau_s[ql], own_k);
              if (bound != nullptr && now < slot_s[ql]) {
                store_bound(bound + (size_t)(q0 + ql) * S + split, now);
                slot_s[ql] = now;
              }
            }
          }
        }
        // the next tile's read-back starts past every row stored so far
        __syncwarp();
        if (lane < kQPW) cnt0_s[warp * kQPW + lane] =
            cnt_s[warp * kQPW + lane];
        if (bound != nullptr &&
            ((tile - row_begin) / kTileN) % kRefresh == kRefresh - 1) {
          // the loads issued together, parked in the warp's (spent) stage
          float fold[kQPW];
#pragma unroll
          for (int i = 0; i < kQPW; ++i) {
            const int qi = q0 + warp * kQPW + i;
            fold[i] = qi < B ? fold_slots(bound + (size_t)qi * S, S, lane)
                             : CUDART_INF_F;
          }
#pragma unroll
          for (int i = 0; i < kQPW; ++i)
            stage_s[(warp * kQPW + i) * kJ + lane] = fold[i];
          __syncwarp();
#pragma unroll 1
          for (int i = 0; i < kQPW; ++i) {
            const int ql = warp * kQPW + i;
            const float shared = pth_fold(stage_s[ql * kJ + lane], P, lane);
            if (lane == 0 && q0 + ql < B)
              tau_s[ql] = fminf(tau_s[ql], shared);
          }
          __syncwarp();
        }
      }
      if (tid == 0) laps.lap(kLapBound);
      tile += kTileN;
      chunk = 0;
    } else {
      ++chunk;
    }
    // the step's stage and decoded tile are read; the bounds written
    __syncthreads();
    if (tid == 0) laps.lap(kLapClose);
  }
  if (tid == 0) laps.flush(n_tiles);

  if (tid < kQT && q0 + tid < B)
    counts[(size_t)(q0 + tid) * S + split] = cnt_s[tid];
}

// ordered bits of a float: a < b as floats iff key(a) < key(b) as unsigned
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fkey_inv(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Query blockIdx.x's pool from its S segments: the rows at or under the
// final bound (the sweep's rule over the final slots; all rows when
// ``bound`` is null), the
// k_run least 64-bit keys (fkey(score), id) found by a radix select and
// sorted; out_d / out_i [B, k_run] (L2 sqrt'd, +inf / -1 padded); the last
// entry (score before the sqrt) to floor_out when set.
__global__ void __launch_bounds__(kSelectThreads)
pq_select_kernel(const int2* __restrict__ buf, int cap,
                 const int* __restrict__ counts,
                 const float* __restrict__ bound, int bound_rank, int S,
                 int k_run, int metric, float* __restrict__ out_d,
                 int* __restrict__ out_i, float* __restrict__ floor_out_d,
                 int* __restrict__ floor_out_i) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long keys[kMaxK];
  __shared__ unsigned tau_key;
  __shared__ int n_cand, n_sel, sh_bin, sh_below, sh_done;
  const int tid = threadIdx.x, qi = blockIdx.x;
#ifdef PG_PROFILE
  const long long t0 = clock64();
#endif
  if (tid < 32) {
    const float tau =
        bound != nullptr
            ? pth_fold(fold_slots(bound + (size_t)qi * S, S, tid),
                       (k_run + bound_rank - 1) / bound_rank, tid)
            : CUDART_INF_F;
    if (tid == 0) {
      tau_key = fkey(tau);
      n_cand = n_sel = 0;
    }
  }
  __syncthreads();
  const unsigned tk = tau_key;
  // every candidate's key, ``fn(key)`` for each
  auto each = [&](auto fn) {
    for (int s = 0; s < S; ++s) {
      const int n = min(counts[(size_t)qi * S + s], cap);
      const int2* seg = buf + ((size_t)qi * S + s) * cap;
      for (int e = tid; e < n; e += kSelectThreads) {
        const int2 v = seg[e];
        const unsigned k = fkey(__int_as_float(v.x));
        if (k <= tk) fn(((unsigned long long)k << 32) | (unsigned)v.y);
      }
    }
  };
  int mine = 0;
  each([&](unsigned long long) { ++mine; });
  atomicAdd(&n_cand, mine);
  __syncthreads();
  // the threshold: every key at or under it is taken, exactly k_run of
  // them (keys are unique: a row is in one segment once)
  unsigned long long thresh = ~0ull;
  if (n_cand > k_run) {
    unsigned long long prefix = 0;
    int need = k_run;
    thresh = 0;                    // the last pass's bin holds one key
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int e = tid; e < 256; e += kSelectThreads) hist[e] = 0;
      __syncthreads();
      each([&](unsigned long long key) {
        if (shift == 56 || ((key ^ prefix) >> (shift + 8)) == 0)
          atomicAdd(&hist[(key >> shift) & 255u], 1u);
      });
      __syncthreads();
      if (tid == 0) {
        int below = 0, b = 0;
        while (below + (int)hist[b] < need) below += hist[b++];
        sh_bin = b;
        sh_below = below;
        sh_done = below + (int)hist[b] == need;
      }
      __syncthreads();
      prefix |= (unsigned long long)sh_bin << shift;
      need -= sh_below;
      thresh = prefix | ((1ull << shift) - 1);
      if (sh_done) break;
      __syncthreads();
    }
  }
  each([&](unsigned long long key) {
    if (key <= thresh) {
      const int at = atomicAdd(&n_sel, 1);
      if (at < kMaxK) keys[at] = key;
    }
  });
  __syncthreads();
  const int n = min(n_sel, k_run);
  int size = 1;
  while (size < n) size <<= 1;
  for (int e = n + tid; e < size; e += kSelectThreads) keys[e] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= size; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int e = tid; e < size; e += kSelectThreads) {
        const int o = e ^ j;
        if (o > e) {
          const unsigned long long a = keys[e], b = keys[o];
          if ((a > b) == ((e & k) == 0)) {
            keys[e] = b;
            keys[o] = a;
          }
        }
      }
      __syncthreads();
    }
  for (int e = tid; e < k_run; e += kSelectThreads) {
    float d = CUDART_INF_F;
    int id = -1;
    if (e < n) {
      d = fkey_inv((unsigned)(keys[e] >> 32));
      id = (int)(unsigned)(keys[e] & 0xffffffffu);
    }
    out_d[(size_t)qi * k_run + e] = metric == kMetricL2 ? sqrtf(d) : d;
    out_i[(size_t)qi * k_run + e] = id;
    if (floor_out_d != nullptr && e == k_run - 1) {
      floor_out_d[qi] = d;
      floor_out_i[qi] = id;
    }
  }
#ifdef PG_PROFILE
  if (tid == 0) {
    atomicAdd(&g_pq_prof[kLaps + 2], (unsigned long long)(clock64() - t0));
    atomicAdd(&g_pq_prof[kLaps + 3], 1ull);
  }
#endif
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

// The compressed sweep's coarse pool, one call of two launches (the sweep,
// then the select): queries q f32[B, D] (contiguous), codes u8[n_rows..,
// G] (D % G == 0), table bf16[ceil(D / 64), 256, 32, 2] (16-byte aligned;
// entry (c, code, p) holds dims 64 c + 2 p and + 1 of that code's decoded
// row, zero past D: ops/cuda_bruteforce.pq_table), del u8[n_rows..] or
// null; S splits (a query tile's side by side) and the shared-memory
// figure from ops/cuda_bruteforce._pq_launch_shape; buf int2[B, S, cap]
// and counts i32[B, S] (the segments and their counts, which go on past
// cap); bound f32[B, S] of +inf and its rank j <= 32 with ceil(k_run /
// j) <= min(S, 32) (ops/cuda_bruteforce._pq_launch_shape), or null and 0;
// out_d f32[B,
// k_run], out_i i32[B, k_run]; floor_d f32[B] / floor_i i32[B], the page
// floor (both null or both set), and floor_out_d / floor_out_i, where the
// select writes the next page's (both null or both set).  Returns the CUDA
// error of the launches (0 on success).
int bruteforce_topk_pq(const float* q, const void* codes, const void* table,
                       const unsigned char* del, int B, int n_rows, int D,
                       int G, int k_run, int metric, int S, int smem_bytes,
                       void* buf, int cap, int* counts, float* bound,
                       int bound_rank, float* out_d, int* out_i,
                       const float* floor_d, const int* floor_i,
                       float* floor_out_d, int* floor_out_i,
                       void* stream_ptr) {
  if (B <= 0 || n_rows < 0 || D <= 0 || G < 1 || G > D || D % G != 0 ||
      k_run < 1 || k_run > kMaxK || S < 1 || S > kMaxSplits || cap < 1 ||
      (metric != kMetricL2 && metric != kMetricCosine &&
       metric != kMetricManhattan) ||
      ceil_div(B, kQT) > 65535 || buf == nullptr || counts == nullptr ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      (floor_d == nullptr) != (floor_i == nullptr) ||
      (floor_out_d == nullptr) != (floor_out_i == nullptr) ||
      (bound == nullptr
           ? bound_rank != 0
           : bound_rank < 1 || bound_rank > kJ || bound_rank > k_run ||
                 (k_run + bound_rank - 1) / bound_rank > min(S, 32)) ||
      smem_bytes != kSmemBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool l1 = metric == kMetricManhattan;
  const void* kernel =
      l1 ? reinterpret_cast<const void*>(pq_sweep_kernel<true>)
         : reinterpret_cast<const void*>(pq_sweep_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split = ceil_div(ceil_div(n_rows, S), kTileN) * kTileN;
  const bool vec_q = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool vec_c =
      G % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const dim3 grid(S, ceil_div(B, kQT));
  const uint8_t* c8 = static_cast<const uint8_t*>(codes);
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  int2* seg = static_cast<int2*>(buf);
  // the seeding launch (the first kSeedTiles tiles of every split, into
  // the same segments, which the sweep proper then overwrites) leaves
  // every slot published before any split sweeps on: a block that starts
  // a wave after its query tile's others is bounded from its first tile
  for (int pass = bound != nullptr && kSeedTiles > 0 ? 0 : 1; pass < 2;
       ++pass) {
    const int limit = pass == 0 ? kSeedTiles : 1 << 30;
    if (l1)
      pq_sweep_kernel<true><<<grid, kThreads, kSmemBytes, stream>>>(
          q, c8, tab, del, B, n_rows, D, G, vec_q, vec_c, k_run, metric,
          rows_per_split, floor_d, floor_i, seg, cap, counts, bound,
          bound_rank, limit);
    else
      pq_sweep_kernel<false><<<grid, kThreads, kSmemBytes, stream>>>(
          q, c8, tab, del, B, n_rows, D, G, vec_q, vec_c, k_run, metric,
          rows_per_split, floor_d, floor_i, seg, cap, counts, bound,
          bound_rank, limit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pq_select_kernel<<<B, kSelectThreads, 0, stream>>>(
      seg, cap, counts, bound, bound_rank, S, k_run, metric, out_d, out_i,
      floor_out_d,
      floor_out_i);
  return (int)cudaGetLastError();
}

// The sweep's shared memory, for the wrapper's launch shape to check.
int pq_topk_smem_bytes() { return kSmemBytes; }

#ifdef PG_PROFILE
// Copies the instrumented build's counters (the sweep's laps' cycles, its
// tiles and blocks, the select's cycles and blocks) to ``out`` and zeroes
// them.
int pq_topk_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_pq_prof, sizeof(g_pq_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kLaps + 4] = {};
  return (int)cudaMemcpyToSymbol(g_pq_prof, zero, sizeof(zero));
}
#endif

}  // extern "C"
