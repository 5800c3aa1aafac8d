// The whole ef-bounded beam walk of a query batch in one launch, for NVIDIA
// Hopper (sm_90a): one thread block per query runs every step of its walk
// with its queues in shared memory, so a batch costs one launch and no
// host round trip per step.
//
// Replaces: pg_embedding_tpu/core/search.py::_search_one (:80), the
// jax.lax.while_loop (:327) that search_graph and search_graph_packed vmap
// over a batch and XLA compiles into one device program.  Its plain twin is
// the port's torch-op walk, core/search._search_batch, and the kernel
// computes, per query, exactly what one lane of that walk computes:
//   * entry node 0 at the caller's entry distance (the twin's own torch op,
//     so both walks start from the same bits); no node: the padding;
//   * loop while cand_d[0] < inf && !(cand_d[0] > res_d[ef-1]);
//   * pop the first T candidates; popped j expands iff
//     !(pop_d[j] > lower) && pop_i[j] >= 0, lower = res_d[ef-1] at the
//     step's start; slot s of the T*maxM expansion is valid iff
//     s % maxM < link_counts[pop], the link is >= 0 and its pop expands;
//   * dense dedupe: skip an id held by the candidate queue after the pop,
//     the result queue or any of the T popped ids, then every valid slot
//     that repeats an earlier valid slot's id;
//   * dist_evals += processed slots; admit d < lower; results keep the ef
//     and candidates the cand_cap smallest of incumbents + admitted, ties
//     to the incumbents, then to the lower slot (merge_min_k after the
//     twin's stable pre-reduce);
//   * distances are ops/distance.dist_one_to_many's in float32: L2
//     sqrtf(sum (p - q)^2), cosine 1 - dot * rsqrtf(max(|q|^2 |p|^2,
//     1e-30)), Manhattan sum |p - q|; products and sums are rounded one by
//     one (no contraction into FMA), as the twin's separate torch ops are.
// Neighbour rows come from the corpus rows f32[cap, D] or from float32
// packed records f32[cap, maxM, D] (record p, slot r holds the row of
// links[p, r]): the same values, so both give the same walk.
//
// What bounds it on an H100: the bytes it must read,
//   sum_q (dist_evals_q * D * 4 + hops_q * T * (maxM + 1) * 4) + B * D * 4,
// about 0.36 ms at 3.35 TB/s for 1,024 queries at 1M x 128-d (ef = 64, T =
// 8, ~2,240 processed neighbours a query).  A walk is a chain of dependent
// steps (mean 17 at T = 8, up to 38), so the design keeps each step's chain
// short and enough queries resident to overlap their latencies.
//
// Design.  A step has five phases, each ended by one block barrier (the
// earlier design's step had six, and serial loops in three of them):
//   1. links: a thread a slot loads the popped row's count and link
//      together (in flight while the thread inserts the queues' ids), and
//      inserts each valid slot's id into a shared hash table keyed by id
//      whose value is the smallest slot holding it (atomicMin); the ids of
//      both queues, the popped ones included, go into a second table (the
//      "held" set).  Both tables are open-addressed with linear probing,
//      sized to a power of two of at least twice their keys;
//   2. dedupe: each slot probes both tables once: it is processed iff its
//      id is not held and it is its id's smallest slot.  That is the dense
//      dedupe's answer, so dist_evals do not change.  Processed slots are
//      compacted with one shared atomic a warp;
//   3. rows: each warp scores kRowsPerWarp = 8 neighbours at a time, their
//      row loads issued together; the metric is a template parameter (no
//      branch per element) and the 8 sums go through one butterfly that
//      also halves the rows each lane carries (9 shuffles, not 40; the
//      same additions, so the same bits), leaving each lane group one
//      row's distance; the admitted (d < lower) are appended with one
//      atomic a warp; the tables are cleared for the next step;
//   4. rank: the admitted are ranked by (d, slot): g lanes an entry (a
//      power of two up to 32, as many as the block can spare), each
//      counting a g-th of the entries below it, then a shuffle sum;
//   5. merge: each queue by rank (an incumbent moves down by the admitted
//      strictly below it, an admitted entry by the incumbents at or below
//      it: binary searches), into its second buffer.
// 128 threads a block where T * maxM <= 128 (T <= 4 at maxM = 32), else
// 256; an SM holds 5 blocks of 128 (96 registers a thread) or 4 of 256
// (64): shapes chosen by measurement (PERF.md; graph_probe.py).  Where
// the tables do not fit beside the queues (very wide D at ef = cand_cap =
// 4096) the dedupe compares each slot with the queues and earlier slots
// instead (the same answer).  Python computes the shared-memory figure
// (ops/cuda_graph._walk_layout) and the launch refuses another one or one
// above 232,448 bytes.
//
// What holds it back now: each step still waits on two dependent global
// latencies (the links, then the rows) plus one for each further round of
// 8 rows a warp, and the block's five barriers make every phase wait for
// its slowest warp; at 64 registers (T = 8) the kernel spills (ptxas).

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
constexpr int kMaxQueue = 4096;          // ef and cand_cap (api max_widen_ef)
constexpr int kMetricL2 = 0;
constexpr int kMetricCosine = 1;
constexpr int kMetricManhattan = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = -1;

// Phase clocks of the instrumented build (-DPG_PROFILE): thread 0 of each
// block sums its laps (each phase ends at a block barrier, so a lap is the
// block's time in it) and adds them to g_walk_prof at the end.
enum { kLapSetup, kLapLinks, kLapDedupe, kLapRows, kLapRank, kLapMerge,
       kLaps };
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
};
#else
struct Laps {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void flush(int) {}
};
#endif

size_t pow2_at_least(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Shared memory: the query row (D rounded up to 4 floats), the result and
// candidate queues twice (d, id), per expansion slot its id, the compacted
// processed slots, the admitted (d, slot) and their ranked (d, id), 8
// counters, then the held table (held_n ids) and the slot table (slot_n
// ids and slot_n smallest slots); both tables are left out (0) where they
// do not fit.
struct WalkLayout {
  size_t smem;
  int held_n, slot_n;
};

WalkLayout walk_layout(int ef, int cap, int T, int maxM, int D) {
  const size_t tm = (size_t)T * maxM;
  const size_t base = 4 * (size_t)((D + 3) / 4 * 4) +
                      16 * ((size_t)ef + cap) + 24 * tm + 32;
  const size_t held = pow2_at_least(2 * ((size_t)ef + cap));
  const size_t slots = pow2_at_least(2 * tm);
  const size_t tables = 4 * held + 8 * slots;
  if (base + tables <= (size_t)kSmemLimit)
    return {base + tables, (int)held, (int)slots};
  return {base, 0, 0};
}

int walk_threads(int T, int maxM) {
  return T * maxM <= 128 ? 128 : 256;
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

// Phase 3's distances: each warp scores kRowsPerWarp processed slots at a
// time (their row loads issued together), and appends those below lower to
// new_ds (d, slot bits) with one atomic a warp.
template <int kMetric, bool kRecords, int kWarps>
__device__ __forceinline__ void score_rows(
    const float* __restrict__ rows, const float* q_s, int D, int vec,
    int maxM, float qq, float lower, const int* proc, int n_proc,
    const int* slot_id, const int* ci, int* n_new, float2* new_ds, int warp,
    int lane) {
  constexpr int R = kRowsPerWarp, kLanesPerRow = 32 / R;
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  for (int e0 = warp * R; e0 < n_proc; e0 += kWarps * R) {
    // each row's index in ``rows`` (-1: none), 32 bits to spare registers
    int at[R];
    float a[R], pp[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      a[u] = pp[u] = 0.f;
      at[u] = -1;
      if (e0 + u < n_proc) {
        const int s = proc[e0 + u];
        at[u] = kRecords ? ci[s / maxM] * maxM + s % maxM : slot_id[s];
      }
    }
    if (vec) {
      const float4* rows4 = reinterpret_cast<const float4*>(rows);
      const int D4 = D / 4;
      for (int c = lane; c < D4; c += 32) {
        const float4 qv = q4[c];
        float4 pv[R];
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (at[u] >= 0) pv[u] = __ldg(rows4 + (size_t)at[u] * D4 + c);
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (at[u] < 0) continue;
          accum<kMetric>(pv[u].x, qv.x, a[u], pp[u]);
          accum<kMetric>(pv[u].y, qv.y, a[u], pp[u]);
          accum<kMetric>(pv[u].z, qv.z, a[u], pp[u]);
          accum<kMetric>(pv[u].w, qv.w, a[u], pp[u]);
        }
      }
    } else {
      for (int c = lane; c < D; c += 32) {
        const float qv = q_s[c];
        float pv[R];
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (at[u] >= 0) pv[u] = __ldg(rows + (size_t)at[u] * D + c);
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (at[u] >= 0) accum<kMetric>(pv[u], qv, a[u], pp[u]);
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
      const float s_pp = rows_sum<R>(pp, lane);
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

template <bool kRecords, int kThreads>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kThreads>)
beam_walk_kernel(const int* __restrict__ links, const int* __restrict__ counts,
                 const float* __restrict__ rows,
                 const float* __restrict__ queries,
                 const float* __restrict__ entry_d, int has_nodes, int D,
                 int maxM, int T, int ef, int cap, int metric, int vec,
                 int held_n, int slot_n, float* __restrict__ out_d,
                 int* __restrict__ out_i, int* __restrict__ out_hops,
                 int* __restrict__ out_evals) {
  constexpr int kWarps = kThreads / 32;
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

  const float* q = queries + (size_t)b * D;
  for (int i = tid; i < Dp; i += kThreads) q_s[i] = i < D ? q[i] : 0.f;
  for (int i = tid; i < ef; i += kThreads) { rd[i] = kInf; ri[i] = -1; }
  for (int i = tid; i < cap; i += kThreads) { cd[i] = kInf; ci[i] = -1; }
  for (int i = tid; i < held_n; i += kThreads) held[i] = kEmpty;
  for (int i = tid; i < slot_n; i += kThreads) {
    slot_key[i] = kEmpty;
    slot_min[i] = INT_MAX;
  }
  if (tid < 4) ctr[tid] = 0;
  __syncthreads();
  if (tid == 0 && has_nodes) {
    rd[0] = cd[0] = entry_d[b];
    ri[0] = ci[0] = 0;
  }
  if (metric == kMetricCosine && warp == 0) {
    float s = 0.f;
    for (int i = lane; i < D; i += 32)
      s = __fadd_rn(s, __fmul_rn(q_s[i], q_s[i]));
    s = warp_sum(s);
    if (lane == 0) ctr[4] = __float_as_int(s);
  }
  __syncthreads();
  const float qq = __int_as_float(ctr[4]);
  int hops = 0, evals = 0;
  if (tid == 0) laps.lap(kLapSetup);

  while (true) {
    const float c0 = cd[0], lower = rd[ef - 1];
    if (!(c0 < kInf && !(c0 > lower))) break;   // uniform: shared reads
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
    if (hashed) {
      for (int i = tid; i < cap + ef; i += kThreads) {
        const int id = i < cap ? ci[i] : ri[i - cap];
        if (id >= 0) held_insert(held, held_n, id);
      }
    }
    for (int s = tid; s < tm; s += kThreads) {
      if (s != tid) load_slot(s, left, link);
      const int id = left > 0 && link >= 0 ? link : -1;
      slot_id[s] = id;
      if (hashed && id >= 0) slot_insert(slot_key, slot_min, slot_n, id, s);
    }
    __syncthreads();
    if (tid == 0) laps.lap(kLapLinks);

    // --- 2. dense dedupe; compact the processed slots, an atomic a warp
    for (int s0 = warp * 32; s0 < tm; s0 += kThreads) {
      const int s = s0 + lane;
      const int id = s < tm ? slot_id[s] : -1;
      bool keep = id >= 0;
      if (keep && hashed) {
        keep = !held_has(held, held_n, id) &&
               slot_first(slot_key, slot_min, slot_n, id) == s;
      } else if (keep) {
        for (int k = 0; keep && k < cap; ++k) keep = ci[k] != id;
        for (int k = 0; keep && k < ef; ++k) keep = ri[k] != id;
        for (int k = 0; keep && k < s; ++k) keep = slot_id[k] != id;
      }
      const unsigned m = __ballot_sync(kFull, keep);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&cnt[0], __popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (keep) proc[at + __popc(m & ((1u << lane) - 1u))] = s;
    }
    __syncthreads();
    const int n_proc = cnt[0];
    if (tid == 0) laps.lap(kLapDedupe);

    // --- 3. the tables' last reader is done: clear them for the next step
    for (int i = tid; i < held_n; i += kThreads) held[i] = kEmpty;
    for (int i = tid; i < slot_n; i += kThreads) {
      slot_key[i] = kEmpty;
      slot_min[i] = INT_MAX;
    }
    // distances, kRowsPerWarp neighbours a warp at a time; admit
    if (metric == kMetricL2)
      score_rows<kMetricL2, kRecords, kWarps>(
          rows, q_s, D, vec, maxM, qq, lower, proc, n_proc, slot_id, ci,
          cnt + 1, new_ds, warp, lane);
    else if (metric == kMetricCosine)
      score_rows<kMetricCosine, kRecords, kWarps>(
          rows, q_s, D, vec, maxM, qq, lower, proc, n_proc, slot_id, ci,
          cnt + 1, new_ds, warp, lane);
    else
      score_rows<kMetricManhattan, kRecords, kWarps>(
          rows, q_s, D, vec, maxM, qq, lower, proc, n_proc, slot_id, ci,
          cnt + 1, new_ds, warp, lane);
    __syncthreads();
    const int n_new = cnt[1];
    if (tid == 0) laps.lap(kLapRows);

    // --- 4. rank the admitted by (d, slot); 5. merge both queues by rank
    if (n_new > 0) {
      const int rest = cap - T;          // incumbents after the pop
      // the admitted ranked by (d, slot) into srt, then each queue merged
      // by binary searches.  g lanes an entry (a power of two up to 32, as
      // many as the block has threads to spare), each counting a g-th of
      // the entries below it, then a shuffle sum over the g
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

template <bool kRecords, int kThreads>
cudaError_t launch(const int* links, const int* counts, const float* rows,
                   const float* queries, const float* entry_d, int has_nodes,
                   int B, int D, int maxM, int T, int ef, int cap, int metric,
                   int vec, WalkLayout lay, float* out_d, int* out_i,
                   int* hops, int* evals, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      beam_walk_kernel<kRecords, kThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
  if (err != cudaSuccess) return err;
  beam_walk_kernel<kRecords, kThreads><<<B, kThreads, lay.smem, stream>>>(
      links, counts, rows, queries, entry_d, has_nodes, D, maxM, T, ef, cap,
      metric, vec, lay.held_n, lay.slot_n, out_d, out_i, hops, evals);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// links i32[cap, maxM], counts i32[cap], rows f32[cap, D] (records = 0) or
// f32[cap, maxM, D] (records = 1), queries f32[B, D], entry_d f32[B] (read
// only when has_nodes), all contiguous; T <= cap, ef and cap <= 4096;
// smem_bytes from ops/cuda_graph._walk_layout.  Writes out_d f32[B, ef],
// out_i i32[B, ef], hops i32[B], evals i32[B].  Returns the launch's CUDA
// error (0 on success).
int beam_walk(const int* links, const int* counts, const float* rows,
              const float* queries, const float* entry_d, int records,
              int has_nodes, int B, int D, int maxM, int T, int ef, int cap,
              int metric, int smem_bytes, float* out_d, int* out_i,
              int* hops, int* evals, void* stream_ptr) {
  if (B <= 0 || D <= 0 || maxM <= 0 || T <= 0 || ef <= 0 || cap <= 0 ||
      T > cap || ef > kMaxQueue || cap > kMaxQueue ||
      (metric != kMetricL2 && metric != kMetricCosine &&
       metric != kMetricManhattan))
    return (int)cudaErrorInvalidValue;
  const WalkLayout lay = walk_layout(ef, cap, T, maxM, D);
  if (lay.smem != (size_t)smem_bytes || lay.smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool wide = walk_threads(T, maxM) > 128;
  auto go = [&](auto kernel_launch) {
    return kernel_launch(links, counts, rows, queries, entry_d, has_nodes, B,
                         D, maxM, T, ef, cap, metric, vec, lay, out_d, out_i,
                         hops, evals, stream);
  };
  cudaError_t err;
  if (records)
    err = wide ? go(launch<true, 256>) : go(launch<true, 128>);
  else
    err = wide ? go(launch<false, 256>) : go(launch<false, 128>);
  return (int)err;
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
