// The build's wiring of one insert batch in one launch, for NVIDIA Hopper
// (sm_90a): every back-link of the batch, appended where its target has
// room and re-pruned by the diversity heuristic where it is full, with no
// host round trip between the rounds.
//
// Replaces: pg_embedding_tpu/core/build.py::_connect_batch (:172), the
// jax.lax.while_loop over back-link rounds (:281) with its while_loop of
// compacted re-prune passes (reprune_pass :235, :276) that the JAX insert
// program runs after the prune.  Its plain twin is core/build's
// _replay_chains (the rounds of _connect_batch_plain); the forward rows and
// the chain order before it stay torch ops on the same stream.
//
// What it computes.  Back-link op o = member * m + slot targets
// kept_i[member, slot] (valid ops only: slot < kept_cnt, id >= 0, member <
// n_insert) and carries cur = base + member.  The caller passes the ops'
// targets stably sorted (keys i32[bm], invalid ops at INT_MAX, and perm
// i64[bm], the ops' indices), so each target's ops form a run in op order:
// a chain.  A target's state depends only on its own chain (a re-prune
// reads its own row and the static vectors), so the block at each chain's
// head replays it alone, op by op:
//   * cnt = link_counts[t] < maxM: links[t, cnt] = cur, cnt + 1;
//   * else the re-prune of hnswalg.cpp:196-220, exactly as the twin's
//     _reprune -> _prune_heuristic: candidates [links[t, :maxM]..., cur]
//     (C = maxM + 1); d = ops/distance.dist_one_to_many(vectors[t], rows)
//     in its difference form (L2 sqrt(sum (p - q)^2), cosine 1 - dot *
//     rsqrt(max(|q|^2 |p|^2, 1e-30)), Manhattan sum |p - q|), with each
//     rounding of a bf16 operand where torch makes it (the difference, the
//     float32 sum rounded once, the sqrt, the bf16 dot and norms);
//     invalid (id < 0 or d not finite) candidates at inf; the scan order
//     is _prune_order's: d ascending, ties larger-id-first, then position;
//     with at least maxM valid candidates, candidate j is kept iff no kept
//     r has pair(j, r) < d_j and fewer than maxM are kept, where pair is
//     ops/distance.pairwise_dist's expansion form (L2 sqrt(max(qq + pp -
//     2 qp, 0)), qq in the rows' dtype, pp and qp float32; cosine 1 - qp *
//     rsqrt(max(qq pp, 1e-30)); Manhattan sum |p - q| in float32), and the
//     kept ids are written in scan order; with fewer, every valid one is
//     kept, farthest first, ties larger-id-first.  The count becomes the
//     kept count and the rest of the row -1.
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn: no
// contraction into an FMA), as the twin's separate torch ops are; a dot
// product accumulates by FMA, as cuBLAS does; sqrt is IEEE, rsqrt CUDA's
// rsqrtf (torch's rsqrt on the card).  On rows whose sums are exact in
// float32 (integer values) the kernel equals the twin bit for bit; else
// the sums' order differs from torch's reductions and matmuls by float32
// rounding only.
//
// What bounds it on an H100: the bytes of the chains' rows (each target's
// row and count read and written once, maxM ints) and of each re-prune's
// C candidate rows (C D elements, read once), over 3.35 TB/s, or the pair
// products of the pruned sets (C^2 / 2 dot products of D) over the float32
// rate: ~1 us at the 1M build's batch (B = 256, m = 16, maxM = 32).
// Nothing near that is reached: a chain is a sequence of dependent ops,
// each re-prune a few block-wide passes, so latency sets the time.
//
// Design: one block of 256 threads a chain head (a grid-stride loop over
// the sorted ops: a block that meets a non-head moves on).  A re-prune
// copies the candidate ids into shared memory; a warp per candidate
// computes its d and squared norm, staging its row in shared memory
// (widened to float32, an odd row stride) where the set's rows fit; each
// valid candidate's scan rank comes from counting the candidates before
// it (a stable order with no sort); then the warps turn the pair
// distances straight into bit masks (bit r of candidate j's row: pair(j,
// r) < d_j, r before j in scan order; a warp task is 4 candidates by 32
// keepers, so a keeper's row is read once for 4 dot products), never
// materialising pair; one warp scans the bits in order as the twin's loop
// does, and the block compacts the keepers into the row.  Tiers by shared
// memory: the rows and masks staged (the main path's sets, C = 33 at D =
// 128); the masks only, rows read through L1 / L2 (wide rows); neither
// (C up to 8,193: the masks in a global scratch, a block's slice each, the
// grid capped by the scratch the wrapper allocates).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;
constexpr int kNoTarget = 0x7fffffff;   // the sort key of an invalid op
constexpr int kRowsPerTask = 4;         // candidates a warp's mask task holds
constexpr unsigned kFull = 0xffffffffu;
enum { kL2 = 0, kCosine = 1, kManhattan = 2 };
// the block's scalars in shared memory
enum { kNValid, kKept, kCount, kScalars = 8 };
// the optional counters (stats): chains, ops, re-prunes, pruned re-prunes,
// pairs tested into masks, valid candidates, the longest chain
enum { kStChains, kStOps, kStReprunes, kStPruned, kStPairs, kStValid,
       kStLongest, kStats = 8 };

// Element access of the rows: float32, or bf16 widened exactly; round()
// is the rounding of a result to the rows' dtype (identity for float32).
struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};
struct BF16 {
  using T = unsigned short;
  static __device__ __forceinline__ float load(const unsigned short* p) {
    return __uint_as_float((unsigned)__ldg(p) << 16);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shared memory of a block, as ops/cuda_graph._connect_layout lays it out:
// ids, d, |p|^2, qq (|p|^2 in the rows' dtype) and the scan order, C each;
// the kept words and their prefix counts, W each; the scalars; then the
// masks [C, W] where they fit, then the staged rows [C, D | 1].
__host__ __device__ inline size_t base_bytes(int C) {
  const int W = (C + 31) / 32;
  return 4 * (5 * (size_t)C + 2 * (size_t)W + kScalars);
}
__host__ __device__ inline size_t mask_bytes(int C) {
  return 4 * (size_t)C * ((C + 31) / 32);
}
__host__ __device__ inline size_t row_bytes(int C, int D) {
  return 4 * (size_t)C * (D | 1);
}

struct Layout {
  bool masks_in_smem, stage;
  size_t smem;
};

__host__ __device__ inline Layout layout(int C, int D) {
  Layout l;
  const size_t base = base_bytes(C), masks = mask_bytes(C);
  l.masks_in_smem = base + masks <= (size_t)kSmemLimit;
  l.stage = l.masks_in_smem && base + masks + row_bytes(C, D) <=
                                   (size_t)kSmemLimit;
  l.smem = base + (l.masks_in_smem ? masks : 0) +
           (l.stage ? row_bytes(C, D) : 0);
  return l;
}

template <class E>
struct Set {
  int* ids;
  float* dk;
  float* sq;
  float* qq;
  int* ord;
  unsigned* kept;
  int* pre;
  int* scalars;
  unsigned* masks;        // [C, W]: shared memory or the block's scratch
  float* rows;            // staged [C, Dp], or null
  const typename E::T* vectors;
  int C, W, D, Dp;
};

// A candidate's row as the mask tasks read it: staged in shared memory, or
// in device memory (through L1 / L2), element k as its float32 value.
struct StagedRow {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const { return p[k]; }
};
template <class E>
struct DeviceRow {
  const typename E::T* p;
  __device__ __forceinline__ float operator[](int k) const {
    return E::load(p + k);
  }
};

// acc[u] = the dot product of rows x[u] and y (Manhattan: the float32 sum
// of |x[u] - y|), k ascending.
template <class R>
__device__ __forceinline__ void row_dots(const R (&x)[kRowsPerTask],
                                         const R& y, int D, int metric,
                                         float (&acc)[kRowsPerTask]) {
#pragma unroll
  for (int u = 0; u < kRowsPerTask; ++u) acc[u] = 0.f;
  if (metric == kManhattan) {
    for (int k = 0; k < D; ++k) {
      const float yk = y[k];
#pragma unroll
      for (int u = 0; u < kRowsPerTask; ++u)
        acc[u] = __fadd_rn(acc[u], fabsf(__fsub_rn(x[u][k], yk)));
    }
  } else {
    for (int k = 0; k < D; ++k) {
      const float yk = y[k];
#pragma unroll
      for (int u = 0; u < kRowsPerTask; ++u)
        acc[u] = __fmaf_rn(x[u][k], yk, acc[u]);
    }
  }
}

// The pair distance of row candidate a (query side) and keeper b, from
// their dot product (or, for Manhattan, the float32 sum of |a - b|).
__device__ __forceinline__ float pair_of(int metric, float acc, float qq_a,
                                         float sq_b) {
  if (metric == kL2) {
    float v = __fsub_rn(__fadd_rn(qq_a, sq_b), __fmul_rn(2.f, acc));
    v = v < 0.f ? 0.f : v;
    return __fsqrt_rn(v);
  }
  if (metric == kCosine) {
    float p = __fmul_rn(qq_a, sq_b);
    p = p < 1e-30f ? 1e-30f : p;
    return __fsub_rn(1.f, __fmul_rn(acc, rsqrtf(p)));
  }
  return acc;
}

// Candidate i's distance to the target row tq and its squared norm, by
// one warp (lanes over the elements); staged, its row goes to shared
// memory on the way.
template <class E>
__device__ void candidate_stats(const Set<E>& s, const typename E::T* tq,
                                int i, int metric, int lane) {
  const int id = s.ids[i];
  if (id < 0) {
    if (lane == 0) {
      s.dk[i] = __int_as_float(0x7f800000);
      s.sq[i] = s.qq[i] = 0.f;
    }
    return;
  }
  const typename E::T* cp = s.vectors + (size_t)id * s.D;
  float a = 0.f, pp = 0.f, nt = 0.f;
  for (int k = lane; k < s.D; k += 32) {
    const float x = E::load(cp + k), y = E::load(tq + k);
    if (s.rows) s.rows[(size_t)i * s.Dp + k] = x;
    pp = __fadd_rn(pp, __fmul_rn(x, x));
    if (metric == kL2) {
      const float e = E::round(__fsub_rn(x, y));
      a = __fadd_rn(a, __fmul_rn(e, e));
    } else if (metric == kCosine) {
      a = __fmaf_rn(x, y, a);
      nt = __fadd_rn(nt, __fmul_rn(y, y));
    } else {
      a = __fadd_rn(a, fabsf(E::round(__fsub_rn(x, y))));
    }
  }
  a = warp_sum(a);
  pp = warp_sum(pp);
  float d;
  if (metric == kL2) {
    d = E::round(__fsqrt_rn(E::round(a)));
  } else if (metric == kCosine) {
    nt = warp_sum(nt);
    float p = E::round(__fmul_rn(E::round(nt), E::round(pp)));
    const float lo = E::round(1e-30f);
    p = p < lo ? lo : p;
    const float r = E::round(rsqrtf(p));
    d = E::round(__fsub_rn(1.f, E::round(__fmul_rn(E::round(a), r))));
  } else {
    d = E::round(a);
  }
  if (lane == 0) {
    const bool finite = fabsf(d) < __int_as_float(0x7f800000);
    s.dk[i] = finite ? d : __int_as_float(0x7f800000);
    s.sq[i] = pp;
    s.qq[i] = E::round(pp);
    if (finite) atomicAdd(&s.scalars[kNValid], 1);
  }
}

// One full target's re-prune: its row and count rewritten.
template <class E>
__device__ void reprune(Set<E>& s, int* links, int* counts, int t, int cur,
                        int max_m, int metric,
                        unsigned long long* __restrict__ stats) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = s.C, W = s.W;
  int* row = links + (size_t)t * max_m;
  for (int i = tid; i < C; i += kThreads) s.ids[i] = i < max_m ? row[i] : cur;
  for (int w = tid; w < W; w += kThreads) s.kept[w] = 0u;
  if (tid == 0) s.scalars[kNValid] = 0;
  __syncthreads();

  const typename E::T* tq = s.vectors + (size_t)t * s.D;
  for (int i = warp; i < C; i += kWarps)
    candidate_stats(s, tq, i, metric, lane);
  __syncthreads();

  const int nv = s.scalars[kNValid];
  const bool prune = nv >= max_m;
  const float kInf = __int_as_float(0x7f800000);
  // each valid candidate's rank: pruned, in scan order (d ascending, ties
  // larger-id-first); unpruned, in (d, id) ascending order, whose reverse
  // is the row; position breaks what remains (the stable sorts)
  for (int i = tid; i < C; i += kThreads) {
    const float di = s.dk[i];
    if (!(di < kInf)) continue;
    const int ii = s.ids[i];
    int r = 0;
    for (int j = 0; j < C; ++j) {
      const float dj = s.dk[j];
      const int ij = s.ids[j];
      const bool id_first = prune ? ij > ii : ij < ii;
      r += dj < di || (dj == di && (id_first || (ij == ii && j < i)));
    }
    if (prune)
      s.ord[r] = i;
    else
      row[nv - 1 - r] = ii;
  }
  if (!prune) {
    for (int j = nv + tid; j < max_m; j += kThreads) row[j] = -1;
    if (tid == 0) {
      counts[t] = nv;
      if (stats) atomicAdd(&stats[kStValid], (unsigned long long)nv);
    }
    return;
  }
  __syncthreads();

  // masks: row j (scan position), word w: bit l set iff keeper r = 32 w +
  // l < j and pair(ord[j], ord[r]) < d[ord[j]]
  const int groups = (nv + kRowsPerTask - 1) / kRowsPerTask;
  for (int g = warp; g < groups; g += kWarps) {
    int a[kRowsPerTask];
#pragma unroll
    for (int u = 0; u < kRowsPerTask; ++u) {
      const int j = g * kRowsPerTask + u;
      a[u] = s.ord[j < nv ? j : 0];
    }
    const int last_w = (g * kRowsPerTask + kRowsPerTask - 1) >> 5;
    for (int w = 0; w <= last_w; ++w) {
      const int r = 32 * w + lane;
      const int b = s.ord[r < nv ? r : 0];
      float acc[kRowsPerTask];
      if (s.rows) {
        StagedRow x[kRowsPerTask];
#pragma unroll
        for (int u = 0; u < kRowsPerTask; ++u)
          x[u].p = s.rows + (size_t)a[u] * s.Dp;
        row_dots(x, StagedRow{s.rows + (size_t)b * s.Dp}, s.D, metric, acc);
      } else {
        DeviceRow<E> x[kRowsPerTask];
#pragma unroll
        for (int u = 0; u < kRowsPerTask; ++u)
          x[u].p = s.vectors + (size_t)s.ids[a[u]] * s.D;
        row_dots(x, DeviceRow<E>{s.vectors + (size_t)s.ids[b] * s.D}, s.D,
                 metric, acc);
      }
#pragma unroll
      for (int u = 0; u < kRowsPerTask; ++u) {
        const int j = g * kRowsPerTask + u;
        const bool bit = j < nv && r < j &&
                         pair_of(metric, acc[u], s.qq[a[u]], s.sq[b]) <
                             s.dk[a[u]];
        const unsigned word = __ballot_sync(kFull, bit);
        if (lane == 0 && j < nv) s.masks[(size_t)j * W + w] = word;
      }
    }
  }
  __syncthreads();

  // the scan, one candidate a step in scan order (the twin's loop)
  if (warp == 0) {
    int k = 0;
    for (int j = 0; j < nv && k < max_m; ++j) {
      bool conflict = false;
      for (int w = lane; w <= (j >> 5); w += 32)
        conflict |= (s.masks[(size_t)j * W + w] & s.kept[w]) != 0u;
      if (!__any_sync(kFull, conflict)) {
        if (lane == 0) s.kept[j >> 5] |= 1u << (j & 31);
        ++k;
      }
      __syncwarp();
    }
    if (lane == 0) {
      int sum = 0;
      for (int w = 0; w < W; ++w) {
        s.pre[w] = sum;
        sum += __popc(s.kept[w]);
      }
      s.scalars[kKept] = k;
    }
  }
  __syncthreads();

  const int k = s.scalars[kKept];
  for (int j = tid; j < nv; j += kThreads) {
    const unsigned word = s.kept[j >> 5];
    if ((word >> (j & 31)) & 1u)
      row[s.pre[j >> 5] + __popc(word & ((1u << (j & 31)) - 1u))] =
          s.ids[s.ord[j]];
  }
  for (int j = k + tid; j < max_m; j += kThreads) row[j] = -1;
  if (tid == 0) {
    counts[t] = k;
    if (stats) {
      atomicAdd(&stats[kStPruned], 1ull);
      atomicAdd(&stats[kStPairs], (unsigned long long)nv * (nv - 1) / 2);
      atomicAdd(&stats[kStValid], (unsigned long long)nv);
    }
  }
}

template <class E, bool kStage>
__global__ void __launch_bounds__(kThreads)
connect_kernel(const typename E::T* __restrict__ vectors, int* links,
               int* counts, const int* __restrict__ keys,
               const long long* __restrict__ perm, int bm, int m, int base,
               int max_m, int D, int metric, unsigned* __restrict__ masks_g,
               unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = max_m + 1, W = (C + 31) / 32;
  Set<E> s;
  s.ids = reinterpret_cast<int*>(smem);
  s.dk = reinterpret_cast<float*>(s.ids + C);
  s.sq = s.dk + C;
  s.qq = s.sq + C;
  s.ord = reinterpret_cast<int*>(s.qq + C);
  s.kept = reinterpret_cast<unsigned*>(s.ord + C);
  s.pre = reinterpret_cast<int*>(s.kept + W);
  s.scalars = s.pre + W;
  unsigned* after = reinterpret_cast<unsigned*>(s.scalars + kScalars);
  s.masks = masks_g ? masks_g + (size_t)blockIdx.x * C * W : after;
  s.rows = kStage ? reinterpret_cast<float*>(after + (size_t)C * W) : nullptr;
  s.vectors = vectors;
  s.C = C;
  s.W = W;
  s.D = D;
  s.Dp = D | 1;

  for (int p = blockIdx.x; p < bm; p += gridDim.x) {
    const int t = keys[p];
    if (t == kNoTarget || (p > 0 && keys[p - 1] == t)) continue;
    int q = p;
    for (; q < bm && keys[q] == t; ++q) {
      const int cur = base + (int)(perm[q] / m);
      __syncthreads();    // the previous op's row and count are written
      // thread 0 alone reads the count and appends; the block reads its
      // copy after the barrier (a thread reading counts[t] itself could
      // see the append and take the other branch)
      if (threadIdx.x == 0) {
        const int cnt = counts[t];
        if (cnt < max_m) {
          links[(size_t)t * max_m + cnt] = cur;
          counts[t] = cnt + 1;
        }
        s.scalars[kCount] = cnt;
      }
      __syncthreads();
      if (s.scalars[kCount] < max_m) continue;
      if (stats && threadIdx.x == 0) atomicAdd(&stats[kStReprunes], 1ull);
      reprune(s, links, counts, t, cur, max_m, metric, stats);
    }
    if (stats && threadIdx.x == 0) {
      atomicAdd(&stats[kStChains], 1ull);
      atomicAdd(&stats[kStOps], (unsigned long long)(q - p));
      atomicMax(&stats[kStLongest], (unsigned long long)(q - p));
    }
  }
}

template <class E>
const void* pick(bool stage) {
  return stage ? (const void*)connect_kernel<E, true>
               : (const void*)connect_kernel<E, false>;
}

}  // namespace

extern "C" {

// vectors [cap, D] (elem 0: float32, 2: bf16), links i32[cap, maxM] and
// counts i32[cap] updated in place, keys i32[bm] sorted (invalid ops at
// INT_MAX) with perm i64[bm] the ops' indices, all contiguous; base, m and
// the metric; smem the bytes ops/cuda_graph._connect_layout gives (checked
// against this file's own figure); blocks the grid; masks a u32[blocks, C,
// W] scratch where the masks do not fit shared memory (else null); stats
// u64[8] counters added to, or null.  Returns the launch's CUDA error (0 on
// success).
int connect_batch(const void* vectors, int elem, int* links, int* counts,
                  const int* keys, const long long* perm, int bm, int m,
                  int base, int max_m, int D, int metric, int smem,
                  int blocks, unsigned* masks, unsigned long long* stats,
                  void* stream_ptr) {
  if (bm <= 0 || m <= 0 || max_m <= 0 || D <= 0 || blocks <= 0 ||
      (elem != 0 && elem != 2) || metric < kL2 || metric > kManhattan)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(max_m + 1, D);
  if (base_bytes(max_m + 1) > (size_t)kSmemLimit || (size_t)smem != l.smem ||
      (masks == nullptr) != l.masks_in_smem)
    return (int)cudaErrorInvalidValue;
  const void* fn = elem == 0 ? pick<F32>(l.stage) : pick<BF16>(l.stage);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&vectors, &links, &counts, &keys, &perm, &bm, &m, &base,
                  &max_m, &D, &metric, &masks, &stats};
  return (int)cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args,
                               (size_t)smem,
                               static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
