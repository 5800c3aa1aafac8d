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
// kernel takes it); queries are always float32.
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
//  * Selection is unchanged: the accumulators become scores in a [QT x 128]
//    shared-memory tile; after one barrier warp w walks the scores of its
//    own QT / 8 queries in ascending row order, a ballot against the k-th
//    finds the rare candidates, and each is inserted into a sorted list of
//    k_run entries by a warp-parallel count and shift.  Pass 2 merges the S
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
constexpr int kMaxSplits = 128;
constexpr int kMaxK = 1024;
constexpr int kSmemLimit = 232448;
constexpr int kMergeWarps = 4;
constexpr int kMetricL2 = 0;
constexpr int kMetricCosine = 1;
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

// Shared memory: the ring (each stage a [128 x kPS] corpus chunk, then,
// when queries stream, a [QT x 36] query chunk), the resident [QT x
// q_res_stride(D)] queries when they do not, the [QT x 136] score tile,
// |q|^2, |p|^2, and the [QT x k_run] running lists (score, id).
template <typename T>
size_t sweep_smem_bytes(int qt, int k_run, int D, bool q_res) {
  const size_t stage = (size_t)kTileN * p_stride<T>() * sizeof(T) +
                       (q_res ? 0 : (size_t)qt * kQStride * sizeof(float));
  return kStages * stage +
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
// sweep_kernel); the query chunk only when queries stream.
template <int QT, bool kQRes, int kPBytes, int kStageBytes, typename T>
__device__ __forceinline__ void load_step(const float* __restrict__ q,
                                          const T* __restrict__ p,
                                          unsigned char* smem, int s, int tile,
                                          int d0, int row_end, int q0, int B,
                                          int D, bool vec_q, bool vec_p,
                                          int tid) {
  unsigned char* stage = smem + (s & 1) * kStageBytes;
  load_chunk<kTileN>(p, reinterpret_cast<T*>(stage), p_stride<T>(), tile,
                     row_end, d0, D, vec_p, tid);
  if (!kQRes)
    load_chunk<QT>(q, reinterpret_cast<float*>(stage + kPBytes), kQStride,
                   q0, B, d0, D, vec_q, tid);
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

__device__ __forceinline__ float score(float dot, float pn, float qn,
                                       int metric) {
  return metric == kMetricL2 ? fmaxf(pn + qn - 2.f * dot, 0.f)
                             : 1.f - dot * rsqrtf(fmaxf(pn * qn, 1e-30f));
}

template <int QT, bool kQRes, typename T>
__global__ void __launch_bounds__(kThreads, 2)
sweep_kernel(const float* __restrict__ q, const T* __restrict__ p,
             const unsigned char* __restrict__ del, int B, int n_rows, int D,
             bool vec_q, bool vec_p, int k_run, int metric,
             int rows_per_split, const float* __restrict__ floor_d,
             const int* __restrict__ floor_i, float* __restrict__ part_d,
             int* __restrict__ part_i) {
  using L = Layout<QT>;
  constexpr int kPS = p_stride<T>();
  constexpr int kPBytes = kTileN * kPS * (int)sizeof(T);
  constexpr bool kExactRows = !std::is_same<T, float>::value;  // bf16
  constexpr int kStageBytes =
      kPBytes + (kQRes ? 0 : QT * kQStride * (int)sizeof(float));
  const int q_all_stride = q_res_stride(D);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_all = reinterpret_cast<float*>(smem + kStages * kStageBytes);
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
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_rows, row_begin + rows_per_split);

  for (int e = tid; e < QT * k_run; e += kThreads) {
    list_d[e] = CUDART_INF_F;
    list_i[e] = -1;
  }
  for (int i = 0; i < L::QPW; ++i) {
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
  float pn_part = 0.f;              // |p|^2 of row tid/2, half tid%2

  if (total > 0) {
    if (kQRes)                  // the whole query tile, once, with step 0
      for (int c = 0; c < n_chunks; ++c)
        load_chunk<QT>(q, q_all + c * kTileD, q_all_stride, q0, B,
                       c * kTileD, D, vec_q, tid);
    load_step<QT, kQRes, kPBytes, kStageBytes>(q, p, smem, 0, row_begin, 0,
                                               row_end, q0, B, D, vec_q, vec_p,
                                               tid);
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
          tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* p_s = reinterpret_cast<const T*>(smem + (s & 1) * kStageBytes);
    const float* q_s =
        kQRes ? q_all + chunk * kTileD
              : reinterpret_cast<const float*>(smem + (s & 1) * kStageBytes +
                                               kPBytes);
    const int qs = kQRes ? q_all_stride : kQStride;

    {
      const T* pr = p_s + (tid >> 1) * kPS + (tid & 1) * (kTileD / 2);
#pragma unroll
      for (int c = 0; c < kTileD / 2; ++c) {
        const float v = widen(pr[c]);
        pn_part = fmaf(v, v, pn_part);
      }
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
        const float y0 = widen(pb[0]), y1 = widen(pb[4]);
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
    // (g+8, 2t+1) of each m16 x n8 tile
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
    float next[kRowsPerLane], next_kth = 0.f;
    if (n_mine > 0) read_query(score_s, list_d, warp * L::QPW, k_run, lane,
                               next, next_kth);
    for (int i = 0; i < n_mine; ++i) {
      const int ql = warp * L::QPW + i;
      float sc[kRowsPerLane];
      float kth = next_kth;
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
        lo = fminf(lo, sc[j]);
      }
      if (i + 1 < n_mine)
        read_query(score_s, list_d, ql + 1, k_run, lane, next, next_kth);
      if (!__any_sync(kFull, lo < kth)) continue;         // the common case
      float* ld = list_d + ql * k_run;
      int* li = list_i + ql * k_run;
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

template <int QT, bool kQRes, typename T>
cudaError_t launch_sweep(const float* q, const T* p,
                         const unsigned char* del, int B, int n_rows, int D,
                         int k_run, int metric, int S, size_t smem,
                         const float* floor_d, const int* floor_i,
                         float* part_d, int* part_i, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<QT, kQRes, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_per_split =
      ceil_div(ceil_div(n_rows, S), kTileN) * kTileN;
  // 16-byte copies need 16-byte rows and a 16-byte aligned base
  const bool vec_q = (D * sizeof(float)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool vec_p = (D * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(p) % 16 == 0;
  dim3 grid(ceil_div(B, QT), S);
  sweep_kernel<QT, kQRes, T><<<grid, kThreads, smem, stream>>>(
      q, p, del, B, n_rows, D, vec_q, vec_p, k_run, metric, rows_per_split,
      floor_d, floor_i, part_d, part_i);
  return cudaGetLastError();
}

template <typename T>
int run_topk(const float* q, const T* p, const unsigned char* del, int B,
             int n_rows, int D, int k_run, int metric, int qt, int S,
             int q_res, int smem_bytes, float* part_d, int* part_i,
             float* out_d, int* out_i, float* floor_d, int* floor_i,
             void* stream_ptr) {
  if (B <= 0 || n_rows < 0 || D <= 0 || k_run < 1 || k_run > kMaxK ||
      S < 1 || S > kMaxSplits || (qt != 64 && qt != 16) ||
      (metric != kMetricL2 && metric != kMetricCosine) ||
      (floor_d == nullptr) != (floor_i == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sweep_smem_bytes<T>(qt, k_run, D, q_res != 0);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (qt == 64)
    err = q_res ? launch_sweep<64, true, T>(q, p, del, B, n_rows, D, k_run,
                                            metric, S, smem, floor_d, floor_i,
                                            part_d, part_i, stream)
                : launch_sweep<64, false, T>(q, p, del, B, n_rows, D, k_run,
                                             metric, S, smem, floor_d, floor_i,
                                             part_d, part_i, stream);
  else
    err = q_res ? launch_sweep<16, true, T>(q, p, del, B, n_rows, D, k_run,
                                            metric, S, smem, floor_d, floor_i,
                                            part_d, part_i, stream)
                : launch_sweep<16, false, T>(q, p, del, B, n_rows, D, k_run,
                                             metric, S, smem, floor_d, floor_i,
                                             part_d, part_i, stream);
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
  return run_topk(q, p, del, B, n_rows, D, k_run, metric, qt, S, q_res,
                  smem_bytes, part_d, part_i, out_d, out_i, floor_d, floor_i,
                  stream_ptr);
}

// The same with p bf16[n_rows.., D] (its raw 16-bit patterns).
int bruteforce_topk_bf16(const float* q, const void* p,
                         const unsigned char* del, int B, int n_rows, int D,
                         int k_run, int metric, int qt, int S, int q_res,
                         int smem_bytes, float* part_d, int* part_i,
                         float* out_d, int* out_i, float* floor_d,
                         int* floor_i, void* stream_ptr) {
  return run_topk(q, static_cast<const uint16_t*>(p), del, B, n_rows, D,
                  k_run, metric, qt, S, q_res, smem_bytes, part_d, part_i,
                  out_d, out_i, floor_d, floor_i, stream_ptr);
}

}  // extern "C"
