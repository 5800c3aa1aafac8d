// The build's wiring of one insert batch in one launch, for NVIDIA Hopper
// (sm_90a): every member's forward row, and every back-link of the batch,
// appended where its target has room and re-pruned by the diversity
// heuristic where it is full, with no host round trip between the rounds.
//
// Replaces: pg_embedding_tpu/core/build.py::_connect_batch (:172): the
// forward rows' scatter (:206-211), the jax.lax.while_loop over back-link
// rounds (:281) and its while_loop of compacted re-prune passes
// (reprune_pass :235, :276) that the JAX insert program runs after the
// prune.  Its plain twin is core/build's _forward_links + _replay_chains
// (_connect_batch_plain); the back-link targets and their stable sort
// before it stay torch ops on the same stream.
//
// What it computes.  Member u < n_insert gets node base + u's forward row:
// kept_i[u, s] for s < kept_cnt[u] where kept_i[u, s] >= 0, else -1, and
// the count kept_cnt[u].  Back-link op o = member * m + slot targets
// kept_i[member, slot] (valid ops only: slot < kept_cnt, id >= 0, member <
// n_insert) and carries cur = base + member.  The caller passes the ops'
// targets stably sorted (keys i32[bm], invalid ops at INT_MAX, and perm
// i64[bm], the ops' indices), so each target's ops form a run in op order:
// a chain.  A target's state depends only on its own chain (a re-prune
// reads its own row and the static vectors), so the chain's head replays
// it alone, in op order, starting from the target's row (a member's: its
// forward row):
//   * cnt < maxM: links[t, cnt] = cur, cnt + 1;
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
// row and count read and written once, maxM ints), of the forward rows
// (kept_i read, n_insert rows written) and of each re-prune's C candidate
// rows (C D elements, read once), over 3.35 TB/s, or the pair products of
// the pruned sets (C^2 / 2 dot products of D) over the float32 rate: ~1.5
// us at the 1M build's batch (B = 256, m = 16, maxM = 32).  The work is a
// few thousand independent chains, almost all one append, and a few
// hundred re-prunes, at most two in a chain: latency sets the time, that
// of the slowest chain with a re-prune.
//
// Design, the warp tier (C <= 64, two candidates a lane: every set of
// config 1, C = 33, D = 128).  A warp per sorted position; a warp whose
// position is not a chain head has nothing to replay, so the slowest chain
// sets the time, not the busiest block.  The head's lanes read the chain's
// ops together (keys, perm) and, in the next round trip, the count and the
// target's row; a chain that only appends (count + length <= maxM, its
// target not a member) stores its ops at links[t, cnt + i] in one store
// by the lanes and the count once, and is done.  Any other chain keeps the
// target's row (a member's forward row from kept_i) in the warp's shared
// memory, appends as far as it fills and re-prunes op by op in op order,
// all inside the warp with no block barrier, then writes the row and count
// once.  A re-prune copies the target's and the C candidates' rows into
// the warp's slice by the copy engine (cp.async.bulk, a row a copy, every
// row in flight, the bytes counted on the warp's mbarrier; rows in their
// own dtype at a stride of a multiple of 8 chunks of 16 bytes, each lane
// walking a row's chunks from its own column on, so a quarter-warp's 16-
// byte loads hit 8 bank groups whatever rows they read; rows whose size is
// no multiple of 16 bytes are copied an element a lane); each lane takes d
// and |p|^2 of its candidates over the whole row; each valid candidate's
// scan rank comes from comparing it with the set in shared memory (a
// stable order with no sort, branch-free); the lanes turn the pair
// distances straight into bit masks in 4 x 4 tiles of the pair matrix's
// lower triangle (16 dot products a tile in registers, float32 FMA, the
// bits ORed into 32-bit halves of the rows' 64-bit words), never
// materialising pair; every lane scans the words in order as the twin's
// loop does (warp-uniform, no vote), and the keepers are compacted by
// their bit's popcount.  Members that no chain targets get their forward
// row from a grid-stride pass over the members, membership by a 32-way
// search of the sorted keys (three dependent loads at bm = 4,096).  Four
// warps a block, 18,352 bytes a warp at config 1 (73,408 a block): three
// blocks an SM, 1,584 warps resident on 132 SMs (ptxas: 128 registers a
// thread for float32 rows, 119 for bf16, no spills).  Tensor cores stay out: a
// re-prune's Gram is 33 x 33 x 128 and the batch's pair work ~33 MFLOP,
// under a microsecond of the float32 rate, so latency bounds it, not
// throughput; a single TF32 pass would also break the agreement with the
// twin on float rows.
//
// What holds it back now (graph_probe --mode wiring, at config 1's 1M
// add() batch): a re-prune's masks take ~19k cycles of one warp for ~3k
// FMA a lane (latency-bound: nothing else on the SMSP), and the masks
// left out the launch takes half the time; the copies ~4k cycles alone,
// ~22k behind the other chains' loads at the launch's start; one chain in
// 237 re-prunes twice and sets the time when the others are quick.
//
// The block tier (C > 64, up to maxM 8,192): a block of 256 threads a
// chain head (a grid-stride loop over the sorted ops), the head's member
// row written first; a re-prune copies the candidate ids into shared
// memory, a warp per candidate computes its d and squared norm, staging
// its row in shared memory (widened to float32, an odd row stride) where
// the set's rows fit; ranks counted as above; the warps turn the pair
// distances into bit masks in tasks of 4 x 32; one warp scans the bits;
// the block compacts the keepers.  Tiers by shared memory: the rows and
// masks staged; the masks only, rows read through L1 / L2 (wide rows);
// neither (C up to 8,193: the masks in a global scratch, a block's slice
// each, the grid capped by the scratch the wrapper allocates).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;           // a block of the block tier
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMaxC = 64;           // the widest set of the warp tier
constexpr int kWarpsPerBlock = 4;       // the warp tier's, where they fit
constexpr int kSmemLimit = 232448;
constexpr int kNoTarget = 0x7fffffff;   // the sort key of an invalid op
constexpr int kRowsPerTask = 4;         // candidates a warp's mask task holds
constexpr int kTile = 4;                // the warp tier's pair tile, kTile^2
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
// A 16-byte chunk holds kPerChunk elements.
struct F32 {
  using T = float;
  static constexpr int kPerChunk = 4;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void chunk(const uint4& c, float* out) {
    out[0] = __uint_as_float(c.x);
    out[1] = __uint_as_float(c.y);
    out[2] = __uint_as_float(c.z);
    out[3] = __uint_as_float(c.w);
  }
};
struct BF16 {
  using T = unsigned short;
  static constexpr int kPerChunk = 8;
  static __device__ __forceinline__ float load(const unsigned short* p) {
    return __uint_as_float((unsigned)__ldg(p) << 16);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void chunk(const uint4& c, float* out) {
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
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

// A candidate's distance to the target from the sums over its row: a =
// sum (p - q)^2 (L2), the dot product (cosine) or sum |p - q| (Manhattan);
// pp = |p|^2, nt = |q|^2 (cosine).
template <class E>
__device__ __forceinline__ float dist_of(int metric, float a, float pp,
                                         float nt) {
  if (metric == kL2) return E::round(__fsqrt_rn(E::round(a)));
  if (metric == kCosine) {
    float p = E::round(__fmul_rn(E::round(nt), E::round(pp)));
    const float lo = E::round(1e-30f);
    p = p < lo ? lo : p;
    const float r = E::round(rsqrtf(p));
    return E::round(__fsub_rn(1.f, E::round(__fmul_rn(E::round(a), r))));
  }
  return E::round(a);
}

// One element of the sums of dist_of: x of the candidate, y of the target.
template <class E>
__device__ __forceinline__ void dist_step(int metric, float x, float y,
                                          float& a, float& pp, float& nt) {
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

// Whether the sorted keys[0, n) hold v, by the whole warp: each round the
// lanes probe 32 evenly spaced keys and keep the span where v would start
// (4,096 keys: two rounds, then one load a lane).
__device__ bool warp_has_key(const int* __restrict__ keys, int n, int v,
                             int lane) {
  int lo = 0, hi = n;     // v's first place is in [lo, hi), or v is absent
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + (lane + 1) * step - 1;
    const bool less = q < hi && __ldg(keys + q) < v;
    const int nlo = lo + __popc(__ballot_sync(kFull, less)) * step;
    hi = min(hi, nlo + step);
    lo = nlo;
  }
  return __ballot_sync(kFull, lo + lane < hi && __ldg(keys + lo + lane) == v)
         != 0u;
}

// Member u's forward row, slot s: kept_i[u, s] where s < kept_cnt[u] and
// the id is valid, else -1 (also past m).
__device__ __forceinline__ int forward_slot(const int* __restrict__ kept_i,
                                            int u, int s, int m, int cnt) {
  if (s >= m || s >= cnt) return -1;
  const int id = __ldg(kept_i + (size_t)u * m + s);
  return id >= 0 ? id : -1;
}

// The members that no chain targets: their forward row and count, a warp a
// member (warp gw of nw); a targeted member's chain head writes its own.
__device__ void untargeted_members(const int* __restrict__ keys, int bm,
                                   const int* __restrict__ kept_i,
                                   const int* __restrict__ kept_cnt,
                                   int* links, int* counts, int m, int base,
                                   int n_insert, int max_m, int gw, int nw,
                                   int lane) {
  for (int u = gw; u < n_insert; u += nw) {
    const int t = base + u;
    if (warp_has_key(keys, bm, t, lane)) continue;
    const int cnt = __ldg(kept_cnt + u);
    for (int s = lane; s < max_m; s += 32)
      links[(size_t)t * max_m + s] = forward_slot(kept_i, u, s, m, cnt);
    if (lane == 0) counts[t] = cnt;
  }
}

// ----------------------------------------------------------------------------
// The block tier
// ----------------------------------------------------------------------------

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
    dist_step<E>(metric, x, y, a, pp, nt);
  }
  a = warp_sum(a);
  pp = warp_sum(pp);
  if (metric == kCosine) nt = warp_sum(nt);
  const float d = dist_of<E>(metric, a, pp, nt);
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
               const long long* __restrict__ perm,
               const int* __restrict__ kept_i,
               const int* __restrict__ kept_cnt, int bm, int m, int base,
               int n_insert, int max_m, int D, int metric,
               unsigned* __restrict__ masks_g,
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
    if (t >= base && t < base + n_insert) {
      // a member's chain starts from its forward row
      const int u = t - base, cnt = __ldg(kept_cnt + u);
      for (int j = threadIdx.x; j < max_m; j += kThreads)
        links[(size_t)t * max_m + j] = forward_slot(kept_i, u, j, m, cnt);
      if (threadIdx.x == 0) counts[t] = cnt;
    }
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
  if (threadIdx.x < 32)
    untargeted_members(keys, bm, kept_i, kept_cnt, links, counts, m, base,
                       n_insert, max_m, blockIdx.x, gridDim.x, threadIdx.x);
}

// ----------------------------------------------------------------------------
// The warp tier
// ----------------------------------------------------------------------------

// 16-byte chunks of a row's elements, and of its stride in the warp's
// shared memory: a multiple of 8, so a chunk's 4-bank group is its column
// mod 8, whatever the row.  Each lane walks a row's chunks starting at its
// own column (lane mod chunks) and wraps, so the 8 lanes of a quarter-warp
// read 8 different groups whichever rows they read (where the chunks are a
// multiple of 8, as at D = 128).
__host__ __device__ inline int row_chunks(int D, int elem_bytes) {
  return (D * elem_bytes + 15) / 16;
}
__host__ __device__ inline int stride_chunks(int D, int elem_bytes) {
  return (row_chunks(D, elem_bytes) + 7) / 8 * 8;
}

// Bytes of one warp's slice, as ops/cuda_graph._connect_warp_bytes gives
// them: the staging's mbarrier (16 bytes); the masks (8 bytes a scan row),
// the chain's row with cur (ids), d, |p|^2, qq and the scan order (4 bytes
// a candidate each), rounded to 16 bytes; then C + 1 rows (the
// candidates', then the target's).
__host__ __device__ inline size_t warp_small_bytes(int C) {
  return 16 + (28 * (size_t)C + 15) / 16 * 16;
}
__host__ __device__ inline size_t warp_bytes(int C, int D, int elem_bytes) {
  return warp_small_bytes(C) +
         (size_t)(C + 1) * stride_chunks(D, elem_bytes) * 16;
}

// The warp tier's warps a block: four where they fit, else as many as do.
__host__ __device__ inline int warp_tier_warps(int C, int D, int elem_bytes) {
  if (C > kWarpMaxC) return 0;
  const size_t per = warp_bytes(C, D, elem_bytes);
  const size_t n = (size_t)kSmemLimit / per;
  return n < (size_t)kWarpsPerBlock ? (int)n : kWarpsPerBlock;
}

// Phase clocks of the instrumented build (-DPG_PROFILE): lane 0 of each
// warp that heads a chain sums its laps and adds them to g_connect_prof at
// the chain's end.
enum { kLapHead, kLapRow, kLapStage, kLapDist, kLapRank, kLapMasks,
       kLapScan, kLapWrite, kLaps };
#ifdef PG_PROFILE
// the laps' cycles, then chains, re-prunes, the longest chain's cycles
__device__ unsigned long long g_connect_prof[kLaps + 3];
struct Laps {
  long long t0, t, acc[kLaps];
  int reprunes;
  __device__ void start() {
    t0 = t = clock64();
    reprunes = 0;
    for (int i = 0; i < kLaps; ++i) acc[i] = 0;
  }
  __device__ void lap(int i) {
    const long long now = clock64();
    acc[i] += now - t;
    t = now;
    reprunes += i == kLapStage;
  }
  __device__ void flush(int lane) {
    if (lane) return;
    for (int i = 0; i < kLaps; ++i)
      atomicAdd(&g_connect_prof[i], (unsigned long long)acc[i]);
    atomicAdd(&g_connect_prof[kLaps], 1ull);
    atomicAdd(&g_connect_prof[kLaps + 1], (unsigned long long)reprunes);
    atomicMax(&g_connect_prof[kLaps + 2], (unsigned long long)(t - t0));
  }
};
#else
struct Laps {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void flush(int) {}
};
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A warp's staging barrier: the bulk copies of a re-prune's rows complete
// their bytes on it; the warp waits for the phase they end.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
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
// The global timer, in nanoseconds.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Waits for the barrier's phase of parity ``phase`` to end.  A copy that
// is only delayed (another context, a profiler's replay) is waited for;
// one that has not landed after 10 s of the global timer traps, a launch
// error in place of a card that never answers again.
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
    const unsigned long long now = global_ns();
    if (start == 0)
      start = now;
    else if (now - start > 10000000000ull)
      __trap();
  }
}

template <class E>
struct WarpSet {
  unsigned long long* bar;     // the staging's mbarrier
  unsigned long long* masks;   // [C]: bit r of row j (scan positions)
  int* ids;                    // [C]: the chain's row, then cur at maxM
  float* dk;
  float* sq;
  float* qq;
  int* ord;
  typename E::T* rows;         // [C + 1] rows of stride elements; the target's last
  int C, D, chunks, stride;    // chunks read a row; stride in elements
};

// The target's and the valid candidates' rows into the warp's slice: a
// bulk copy a row (the copy engine's cp.async.bulk), lane l issuing rows
// l, l + 32, l + 64, every row in flight, their bytes completing on the
// warp's barrier (phase flips each staging); rows whose bytes are no
// multiple of 16 (or a base that is not 16-byte aligned) an element a
// lane, zero-padded to whole chunks.
template <class E>
__device__ void stage_rows(const WarpSet<E>& s,
                           const typename E::T* __restrict__ vectors, int t,
                           bool chunked, unsigned& phase, int lane) {
  using T = typename E::T;
  const int C = s.C, D = s.D;
  if (chunked) {
    const unsigned row_bytes = D * (unsigned)sizeof(T);
    int rows = 0;
    for (int i0 = 0; i0 <= C; i0 += 32)
      rows += __popc(__ballot_sync(
          kFull, i0 + lane <= C && (i0 + lane == C || s.ids[i0 + lane] >= 0)));
    // the rows' earlier readers are done (the warp synchronised) before the
    // copy engine writes them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_expect(s.bar, rows * row_bytes);
    __syncwarp();
    for (int i = lane; i <= C; i += 32) {
      const int id = i < C ? s.ids[i] : t;
      if (id >= 0)
        bulk_copy(s.rows + (size_t)i * s.stride, vectors + (size_t)id * D,
                  row_bytes, s.bar);
    }
    mbar_wait(s.bar, phase);
    phase ^= 1u;
  } else {
    const int width = s.chunks * E::kPerChunk;
    for (int i = 0; i <= C; ++i) {
      const int id = i < C ? s.ids[i] : t;
      if (id < 0) continue;
      for (int k = lane; k < width; k += 32)
        s.rows[(size_t)i * s.stride + k] =
            k < D ? vectors[(size_t)id * D + k] : T(0);
    }
  }
  __syncwarp();
}

// Candidate i's sums over its staged row against the target's, the chunks
// from the lane's own column on (the zero padding past D adds nothing): d
// and |p|^2.  One instance a metric, so the loop carries no branch.
template <class E, int kMetric>
__device__ __forceinline__ void warp_candidate_of(const WarpSet<E>& s,
                                                  int i, int lane, float& d,
                                                  float& pp) {
  const uint4* x = reinterpret_cast<const uint4*>(s.rows +
                                                  (size_t)i * s.stride);
  const uint4* y = reinterpret_cast<const uint4*>(s.rows +
                                                  (size_t)s.C * s.stride);
  float a = 0.f, nt = 0.f;
  pp = 0.f;
  int cc = lane % s.chunks;
#pragma unroll 4
  for (int c = 0; c < s.chunks; ++c, cc = cc + 1 == s.chunks ? 0 : cc + 1) {
    float xv[E::kPerChunk], yv[E::kPerChunk];
    E::chunk(x[cc], xv);
    E::chunk(y[cc], yv);
#pragma unroll
    for (int e = 0; e < E::kPerChunk; ++e)
      dist_step<E>(kMetric, xv[e], yv[e], a, pp, nt);
  }
  d = dist_of<E>(kMetric, a, pp, nt);
}

template <class E>
__device__ void warp_candidate(const WarpSet<E>& s, int i, int lane,
                               int metric, float& d, float& pp) {
  if (metric == kL2)
    warp_candidate_of<E, kL2>(s, i, lane, d, pp);
  else if (metric == kCosine)
    warp_candidate_of<E, kCosine>(s, i, lane, d, pp);
  else
    warp_candidate_of<E, kManhattan>(s, i, lane, d, pp);
}

// Tile t of the lower triangle of 4 x 4 blocks: t = J (J + 1) / 2 + R,
// R <= J.
__device__ __forceinline__ void tile_blocks(int t, int& J, int& R) {
  J = 0;
  while ((J + 1) * (J + 2) / 2 <= t) ++J;
  R = t - J * (J + 1) / 2;
}

// The masks of a pruned set in scan order: masks[j] bit r set iff r < j
// and pair(ord[j], ord[r]) < d[ord[j]] (j, r < nv).  The lanes take 4 x 4
// tiles of the pair matrix's lower triangle (row block >= column block) in
// turn, 16 dot products a tile in registers (kAbs, Manhattan's: the
// float32 sums of |a - b|), each by FMA over the chunks from the lane's
// own column on, the tile's 4 rows read once a chunk for 4 keepers; a
// tile's bits go to its rows' words by a shared-memory atomicOr on the
// 32-bit half that holds them (4 keepers from a multiple of 4 never
// straddle it; a 64-bit atomicOr would be a compare-and-swap loop).
template <class E, bool kAbs>
__device__ void warp_masks_of(const WarpSet<E>& s, int nv, int metric,
                              int lane) {
  constexpr int P = E::kPerChunk;
  const int nb = (nv + kTile - 1) / kTile, tiles = nb * (nb + 1) / 2;
  const uint4* rows = reinterpret_cast<const uint4*>(s.rows);
  const int stride = s.stride / P;                  // chunks a staged row
  for (int tile = lane; tile - lane < tiles; tile += 32) {
    int J, R;
    tile_blocks(tile, J, R);
    int a[kTile], b[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      a[u] = s.ord[min(J * kTile + u, nv - 1)];
      b[u] = s.ord[min(R * kTile + u, nv - 1)];
    }
    float acc[kTile][kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v) acc[u][v] = 0.f;
    int cc = lane % s.chunks;
#pragma unroll 2
    for (int c = 0; c < s.chunks; ++c, cc = cc + 1 == s.chunks ? 0 : cc + 1) {
      float x[kTile][P];
#pragma unroll
      for (int u = 0; u < kTile; ++u)
        E::chunk(rows[a[u] * stride + cc], x[u]);
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        float y[P];
        E::chunk(rows[b[v] * stride + cc], y);
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int e = 0; e < P; ++e)
            acc[u][v] = kAbs
                ? __fadd_rn(acc[u][v], fabsf(__fsub_rn(x[u][e], y[e])))
                : __fmaf_rn(x[u][e], y[e], acc[u][v]);
      }
    }
    if (tile >= tiles) continue;
    const int half = R * kTile >> 5;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int j = J * kTile + u;
      if (j >= nv) continue;
      unsigned bits = 0u;
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        const int r = R * kTile + v;
        bits |= (unsigned)((r < j) &
                           (pair_of(metric, acc[u][v], s.qq[a[u]],
                                    s.sq[b[v]]) < s.dk[a[u]]))
                << (r & 31);
      }
      if (bits)
        atomicOr(reinterpret_cast<unsigned*>(s.masks + j) + half, bits);
    }
  }
}

template <class E>
__device__ void warp_masks(const WarpSet<E>& s, int nv, int metric,
                           int lane) {
  for (int j = lane; j < nv; j += 32) s.masks[j] = 0ull;
  __syncwarp();
  if (metric == kManhattan)
    warp_masks_of<E, true>(s, nv, metric, lane);
  else
    warp_masks_of<E, false>(s, nv, metric, lane);
  __syncwarp();
}

// The re-prune of the chain's row s.ids[0, maxM) with cur at s.ids[maxM],
// inside one warp: the new row in s.ids[0, maxM); returns its count.
template <class E>
__device__ int warp_reprune(const WarpSet<E>& s,
                            const typename E::T* __restrict__ vectors, int t,
                            int max_m, int metric, bool chunked,
                            unsigned& phase, int lane,
                            unsigned long long* __restrict__ stats,
                            Laps& laps) {
  const int C = s.C;
  const float kInf = __int_as_float(0x7f800000);
  stage_rows(s, vectors, t, chunked, phase, lane);
  laps.lap(kLapStage);

  // d and |p|^2 of the lane's candidates, lane and lane + 32
  bool valid[2];
  int id[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    valid[h] = false;
    id[h] = i < C ? s.ids[i] : -1;
    if (i >= C) continue;
    float d = kInf, pp = 0.f;
    if (id[h] >= 0) {
      warp_candidate(s, i, lane, metric, d, pp);
      valid[h] = fabsf(d) < kInf;
    }
    s.dk[i] = valid[h] ? d : kInf;
    s.sq[i] = pp;
    s.qq[i] = E::round(pp);
  }
  const int nv = __popc(__ballot_sync(kFull, valid[0])) +
                 __popc(__ballot_sync(kFull, valid[1]));
  const bool prune = nv >= max_m;
  __syncwarp();
  laps.lap(kLapDist);

  // each valid candidate's rank: pruned, in scan order (d ascending, ties
  // larger-id-first); unpruned, in (d, id) ascending order, whose reverse
  // is the row; position breaks what remains (the stable sorts)
  int rank[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    rank[h] = -1;
    if (!valid[h]) continue;
    const float di = s.dk[i];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < C; ++j) {
      // bitwise, not short-circuit: no branch a candidate
      const float dj = s.dk[j];
      const int ij = s.ids[j];
      const bool id_first = prune ? ij > id[h] : ij < id[h];
      r += (dj < di) | ((dj == di) & (id_first | ((ij == id[h]) & (j < i))));
    }
    rank[h] = r;
  }
  if (!prune) {
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rank[h] >= 0) s.ids[nv - 1 - rank[h]] = id[h];
    for (int j = nv + lane; j < max_m; j += 32) s.ids[j] = -1;
    __syncwarp();
    if (stats && lane == 0)
      atomicAdd(&stats[kStValid], (unsigned long long)nv);
    laps.lap(kLapRank);
    return nv;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (rank[h] >= 0) s.ord[rank[h]] = lane + 32 * h;
  __syncwarp();
  laps.lap(kLapRank);

  // masks: row j (scan position), bit r set iff keeper r < j and
  // pair(ord[j], ord[r]) < d[ord[j]]
  warp_masks(s, nv, metric, lane);
  laps.lap(kLapMasks);

  // the scan, one candidate a step in scan order (the twin's loop), the
  // same in every lane
  unsigned long long kept = 0ull;
  int k = 0;
#pragma unroll 8
  for (int j = 0; j < nv && k < max_m; ++j)
    if ((s.masks[j] & kept) == 0ull) {
      kept |= 1ull << j;
      ++k;
    }
  // the keepers in scan order: scan position j goes to the popcount of
  // the kept bits below it
  int slot[2], val[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    slot[h] = -1;
    if (j < nv && ((kept >> j) & 1ull)) {
      slot[h] = __popcll(kept & ((1ull << j) - 1ull));
      val[h] = s.ids[s.ord[j]];
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (slot[h] >= 0) s.ids[slot[h]] = val[h];
  for (int j = k + lane; j < max_m; j += 32) s.ids[j] = -1;
  __syncwarp();
  if (stats && lane == 0) {
    atomicAdd(&stats[kStPruned], 1ull);
    atomicAdd(&stats[kStPairs], (unsigned long long)nv * (nv - 1) / 2);
    atomicAdd(&stats[kStValid], (unsigned long long)nv);
  }
  laps.lap(kLapScan);
  return k;
}

// The chain at sorted position p, if p is a chain's head, by one warp.
template <class E>
__device__ void warp_chain(const WarpSet<E>& s,
                           const typename E::T* __restrict__ vectors,
                           int* links, int* counts,
                           const int* __restrict__ keys,
                           const long long* __restrict__ perm,
                           const int* __restrict__ kept_i,
                           const int* __restrict__ kept_cnt, int p, int bm,
                           int m, int base, int n_insert, int max_m,
                           int metric, bool chunked, unsigned& phase,
                           int lane, unsigned long long* __restrict__ stats) {
  Laps laps;
  laps.start();
  // the first 32 ops from p, the key before p
  int kk = p + lane < bm ? __ldg(keys + p + lane) : kNoTarget;
  long long op = p + lane < bm ? __ldg(perm + p + lane) : 0;
  const int prev = p > 0 ? __ldg(keys + p - 1) : kNoTarget;
  const int t = __shfl_sync(kFull, kk, 0);
  if (t == kNoTarget || prev == t) return;
  const bool member = t >= base && t < base + n_insert;
  int n = __popc(__ballot_sync(kFull, kk == t));   // ops in this chunk
  int* row = links + (size_t)t * max_m;
  // the count, and beside it the row a re-prune will need (two slots a
  // lane: maxM < 64), in one round trip
  const int cnt0 = member ? __ldg(kept_cnt + t - base) : counts[t];
  int slots[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    slots[h] = j >= max_m ? -1
               : member   ? forward_slot(kept_i, t - base, j, m, cnt0)
                          : row[j];
  }
  int cnt = cnt0;
  if (!member && n < 32 && cnt + n <= max_m) {
    // appends only: one store by the lanes, the count once
    if (lane < n) row[cnt + lane] = base + (int)(op / m);
    if (lane == 0) {
      counts[t] = cnt + n;
      if (stats) {
        atomicAdd(&stats[kStChains], 1ull);
        atomicAdd(&stats[kStOps], (unsigned long long)n);
        atomicMax(&stats[kStLongest], (unsigned long long)n);
      }
    }
    laps.lap(kLapHead);
    laps.flush(lane);
    return;
  }
  laps.lap(kLapHead);
  // the row into shared memory: a member's forward row, else links[t]
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h < max_m) s.ids[lane + 32 * h] = slots[h];
  __syncwarp();
  laps.lap(kLapRow);
  int total = 0, q0 = p;
  while (n > 0) {
    const int cur = base + (int)(op / m);
    // ops [x, n) of this chunk: append while there is room, else re-prune
    for (int x = 0; x < n;) {
      const int n_app = max(0, min(n - x, max_m - cnt));
      if (lane >= x && lane < x + n_app) s.ids[cnt + lane - x] = cur;
      cnt += n_app;
      x += n_app;
      if (x == n) break;
      const int c = __shfl_sync(kFull, cur, x);
      if (lane == 0) {
        s.ids[max_m] = c;
        if (stats) atomicAdd(&stats[kStReprunes], 1ull);
      }
      __syncwarp();
      cnt = warp_reprune(s, vectors, t, max_m, metric, chunked, phase, lane,
                         stats, laps);
      ++x;
    }
    total += n;
    if (n < 32) break;
    q0 += 32;
    kk = q0 + lane < bm ? __ldg(keys + q0 + lane) : kNoTarget;
    op = q0 + lane < bm ? __ldg(perm + q0 + lane) : 0;
    n = __popc(__ballot_sync(kFull, kk == t));
  }
  __syncwarp();
  for (int j = lane; j < max_m; j += 32) row[j] = s.ids[j];
  if (lane == 0) {
    counts[t] = cnt;
    if (stats) {
      atomicAdd(&stats[kStChains], 1ull);
      atomicAdd(&stats[kStOps], (unsigned long long)total);
      atomicMax(&stats[kStLongest], (unsigned long long)total);
    }
  }
  laps.lap(kLapWrite);
  laps.flush(lane);
}

template <class E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
connect_warp_kernel(const typename E::T* __restrict__ vectors, int* links,
                    int* counts, const int* __restrict__ keys,
                    const long long* __restrict__ perm,
                    const int* __restrict__ kept_i,
                    const int* __restrict__ kept_cnt, int bm, int m,
                    int base, int n_insert, int max_m, int D, int metric,
                    unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = typename E::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = max_m + 1, warps = blockDim.x >> 5;
  WarpSet<E> s;
  unsigned char* mine = smem + warp * warp_bytes(C, D, (int)sizeof(T));
  s.bar = reinterpret_cast<unsigned long long*>(mine);
  s.masks = s.bar + 2;
  s.ids = reinterpret_cast<int*>(s.masks + C);
  s.dk = reinterpret_cast<float*>(s.ids + C);
  s.sq = s.dk + C;
  s.qq = s.sq + C;
  s.ord = reinterpret_cast<int*>(s.qq + C);
  s.rows = reinterpret_cast<T*>(mine + warp_small_bytes(C));
  s.C = C;
  s.D = D;
  s.chunks = row_chunks(D, (int)sizeof(T));
  s.stride = stride_chunks(D, (int)sizeof(T)) * E::kPerChunk;
  const bool chunked = (D * (int)sizeof(T)) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(vectors) & 15) == 0;
  const int gw = blockIdx.x * warps + warp, nw = gridDim.x * warps;
  if (lane == 0) mbar_init(s.bar);
  __syncwarp();
  unsigned phase = 0u;

  for (int p = gw; p < bm; p += nw)
    warp_chain(s, vectors, links, counts, keys, perm, kept_i, kept_cnt, p,
               bm, m, base, n_insert, max_m, metric, chunked, phase, lane,
               stats);
  untargeted_members(keys, bm, kept_i, kept_cnt, links, counts, m, base,
                     n_insert, max_m, gw, nw, lane);
}

// The six instances, by rows' dtype and tier, and the shared memory each
// was last allowed on each device (cudaFuncSetAttribute once an instance
// and size, not a launch).
enum { kWarpF32, kWarpBF16, kBlockF32, kBlockBF16, kStagedF32, kStagedBF16,
       kInstances };
constexpr int kMaxDevices = 64;
std::atomic<int> allowed_smem[kMaxDevices][kInstances];

const void* instance(int which) {
  switch (which) {
    case kWarpF32: return (const void*)connect_warp_kernel<F32>;
    case kWarpBF16: return (const void*)connect_warp_kernel<BF16>;
    case kBlockF32: return (const void*)connect_kernel<F32, false>;
    case kBlockBF16: return (const void*)connect_kernel<BF16, false>;
    case kStagedF32: return (const void*)connect_kernel<F32, true>;
    default: return (const void*)connect_kernel<BF16, true>;
  }
}

cudaError_t allow_smem(int which, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* seen =
      dev < kMaxDevices ? &allowed_smem[dev][which] : nullptr;
  if (seen && seen->load(std::memory_order_relaxed) >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(instance(which),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && seen) {
    int had = seen->load(std::memory_order_relaxed);
    while (had < smem && !seen->compare_exchange_weak(had, smem)) {
    }
  }
  return err;
}

}  // namespace

extern "C" {

// vectors [cap, D] (elem 0: float32, 2: bf16), links i32[cap, maxM] and
// counts i32[cap] updated in place, keys i32[bm] sorted (invalid ops at
// INT_MAX) with perm i64[bm] the ops' indices, kept_i i32[b, m] and
// kept_cnt i32[b] the members' pruned lists (bm = b m), all contiguous;
// base, n_insert, m and the metric; smem the bytes of a block
// (ops/cuda_graph._connect_layout's, checked against this file's own
// figure; the warp tier's block holds smem / its warp's bytes warps);
// blocks the grid; masks a u32[blocks, C, W] scratch where the block
// tier's masks do not fit shared memory (else null); stats u64[8] counters
// added to, or null.  Returns the launch's CUDA error (0 on success).
int connect_batch(const void* vectors, int elem, int* links, int* counts,
                  const int* keys, const long long* perm, const int* kept_i,
                  const int* kept_cnt, int b, int m, int base, int n_insert,
                  int max_m, int D, int metric, int smem, int blocks,
                  unsigned* masks, unsigned long long* stats,
                  void* stream_ptr) {
  if (b <= 0 || m <= 0 || max_m < m || D <= 0 || blocks <= 0 ||
      n_insert < 0 || n_insert > b || base < 0 ||
      (elem != 0 && elem != 2) || metric < kL2 || metric > kManhattan)
    return (int)cudaErrorInvalidValue;
  const int C = max_m + 1;
  int bm = b * m;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int es = elem == 0 ? 4 : 2;
  const int warps = warp_tier_warps(C, D, es);
  if (warps > 0) {
    if ((size_t)smem != warps * warp_bytes(C, D, es) || masks != nullptr)
      return (int)cudaErrorInvalidValue;
    const int which = elem == 0 ? kWarpF32 : kWarpBF16;
    cudaError_t err = allow_smem(which, smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&vectors, &links, &counts, &keys, &perm, &kept_i,
                    &kept_cnt, &bm, &m, &base, &n_insert, &max_m, &D, &metric,
                    &stats};
    return (int)cudaLaunchKernel(instance(which), dim3(blocks),
                                 dim3(32 * warps), args, (size_t)smem,
                                 stream);
  }
  const Layout l = layout(C, D);
  if (base_bytes(C) > (size_t)kSmemLimit || (size_t)smem != l.smem ||
      (masks == nullptr) != l.masks_in_smem)
    return (int)cudaErrorInvalidValue;
  const int which = l.stage ? (elem == 0 ? kStagedF32 : kStagedBF16)
                            : (elem == 0 ? kBlockF32 : kBlockBF16);
  cudaError_t err = allow_smem(which, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&vectors, &links, &counts, &keys, &perm, &kept_i,
                  &kept_cnt, &bm, &m, &base, &n_insert, &max_m, &D, &metric,
                  &masks, &stats};
  return (int)cudaLaunchKernel(instance(which), dim3(blocks),
                               dim3(kThreads), args, (size_t)smem, stream);
}

#ifdef PG_PROFILE
// Copies the instrumented build's counters (the warp tier's laps' cycles,
// chains, re-prunes, the longest chain's cycles) to ``out`` and zeroes
// them.
int connect_batch_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_connect_prof,
                                         sizeof(g_connect_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kLaps + 3] = {};
  return (int)cudaMemcpyToSymbol(g_connect_prof, zero, sizeof(zero));
}
#endif

}  // extern "C"
