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
// about 0.25 ms at 3.35 TB/s for 1,024 queries at 1M x 128-d (ef = 64, T =
// 4, ~1,500 processed neighbours a query).  Nothing like that is reached:
// a walk is a chain of dependent gathers (~27 steps a query at T = 4, up
// to 55), each step waiting on its links, then on its rows, then on the
// block's barriers, so latency sets the time, not bytes.
//
// Design, simple first.  256 threads a block; the whole batch is resident
// at once at small ef (a block needs ~9 KB of shared memory at ef = 64, T =
// 8), so the card overlaps the blocks' latencies.  Each step: threads take
// slots for the links loads and for the dedupe, whose compares against the
// queues read shared memory (all lanes read one address at a time, a
// broadcast); processed slots are compacted with a shared counter; each
// warp scores four neighbours at a time (their 16-byte row loads issued
// together, then a shuffle reduction over D); the admitted entries are
// ranked by (d, slot) with an all-pairs count, and each queue is merged by
// rank: an incumbent moves down by the admitted entries strictly below it,
// an admitted entry by the incumbents at or below it (binary searches),
// into the queue's second buffer.  Python computes the shared-memory figure
// (ops/cuda_graph._walk_smem_bytes) and the launch refuses another one or
// one above 232,448 bytes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;      // neighbour rows a warp scores at once
constexpr int kSmemLimit = 232448;
constexpr int kMaxQueue = 4096;      // ef and cand_cap (api max_widen_ef)
constexpr int kMetricL2 = 0;
constexpr int kMetricCosine = 1;
constexpr int kMetricManhattan = 2;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory: the query row (D rounded up to 4 floats), the result and
// candidate queues twice (d, id), per expansion slot its id, the compacted
// processed slots, the admitted (d, slot) and their ranked (d, id), per
// popped candidate its id and expand flag, and 4 counters.
size_t walk_smem_bytes(int ef, int cap, int T, int maxM, int D) {
  const size_t tm = (size_t)T * maxM;
  return 4 * (size_t)((D + 3) / 4 * 4) + 16 * ((size_t)ef + cap) +
         24 * tm + 8 * (size_t)T + 16;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Accumulate one element pair into the metric's sums.
__device__ __forceinline__ void accum(int metric, float p, float q,
                                      float& a, float& pp) {
  if (metric == kMetricL2) {
    const float t = __fsub_rn(p, q);
    a = __fadd_rn(a, __fmul_rn(t, t));
  } else if (metric == kMetricCosine) {
    a = __fadd_rn(a, __fmul_rn(p, q));
    pp = __fadd_rn(pp, __fmul_rn(p, p));
  } else {
    a = __fadd_rn(a, fabsf(__fsub_rn(p, q)));
  }
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

template <bool kRecords>
__global__ void __launch_bounds__(kThreads)
beam_walk_kernel(const int* __restrict__ links, const int* __restrict__ counts,
                 const float* __restrict__ rows,
                 const float* __restrict__ queries,
                 const float* __restrict__ entry_d, int has_nodes, int D,
                 int maxM, int T, int ef, int cap, int metric, int vec,
                 float* __restrict__ out_d, int* __restrict__ out_i,
                 int* __restrict__ out_hops, int* __restrict__ out_evals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float kInf = __int_as_float(0x7f800000);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tm = T * maxM;
  const int Dp = (D + 3) / 4 * 4;
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
  float* new_d = reinterpret_cast<float*>(proc + tm);
  int* new_s = reinterpret_cast<int*>(new_d + tm);
  float* srt_d = reinterpret_cast<float*>(new_s + tm);
  int* srt_i = reinterpret_cast<int*>(srt_d + tm);
  int* pop_i = srt_i + tm;
  int* pop_x = pop_i + T;
  int* ctr = pop_x + T;          // processed, admitted, |q|^2 bits

  const float* q = queries + (size_t)b * D;
  for (int i = tid; i < Dp; i += kThreads) q_s[i] = i < D ? q[i] : 0.f;
  for (int i = tid; i < ef; i += kThreads) { rd[i] = kInf; ri[i] = -1; }
  for (int i = tid; i < cap; i += kThreads) { cd[i] = kInf; ci[i] = -1; }
  __syncthreads();
  if (tid == 0 && has_nodes) {
    rd[0] = cd[0] = entry_d[b];
    ri[0] = ci[0] = 0;
  }
  if (metric == kMetricCosine && warp == 0) {
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s = __fadd_rn(s, __fmul_rn(q_s[i], q_s[i]));
    s = warp_sum(s);
    if (lane == 0) ctr[2] = __float_as_int(s);
  }
  __syncthreads();
  const float qq = __int_as_float(ctr[2]);
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  int hops = 0, evals = 0;

  while (true) {
    const float c0 = cd[0], lower = rd[ef - 1];
    if (!(c0 < kInf && !(c0 > lower))) break;   // uniform: shared reads

    // --- pop the best T; the candidate queue after the pop is cd[T, cap)
    for (int j = tid; j < T; j += kThreads) {
      pop_i[j] = ci[j];
      pop_x[j] = !(cd[j] > lower) && ci[j] >= 0;
    }
    if (tid == 0) ctr[0] = ctr[1] = 0;
    __syncthreads();

    // --- the expansion's valid slots
    for (int s = tid; s < tm; s += kThreads) {
      const int j = s / maxM, r = s - j * maxM;
      int id = -1;
      if (pop_x[j]) {
        const int p = pop_i[j];
        if (r < counts[p]) {
          const int l = links[(size_t)p * maxM + r];
          if (l >= 0) id = l;
        }
      }
      slot_id[s] = id;
    }
    __syncthreads();

    // --- dense dedupe; compact the processed slots
    for (int s = tid; s < tm; s += kThreads) {
      const int id = slot_id[s];
      bool keep = id >= 0;
      for (int k = T; keep && k < cap; ++k) keep = ci[k] != id;
      for (int k = 0; keep && k < ef; ++k) keep = ri[k] != id;
      for (int k = 0; keep && k < T; ++k) keep = pop_i[k] != id;
      for (int k = 0; keep && k < s; ++k) keep = slot_id[k] != id;
      if (keep) proc[atomicAdd(&ctr[0], 1)] = s;
    }
    __syncthreads();
    const int n_proc = ctr[0];

    // --- distances, kRowsPerWarp neighbours a warp at a time; admit
    for (int e0 = warp * kRowsPerWarp; e0 < n_proc;
         e0 += kWarps * kRowsPerWarp) {
      const float* row[kRowsPerWarp];
      float a[kRowsPerWarp], pp[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        a[u] = pp[u] = 0.f;
        row[u] = nullptr;
        if (e0 + u < n_proc) {
          const int s = proc[e0 + u];
          const size_t at =
              kRecords ? (size_t)pop_i[s / maxM] * maxM + s % maxM
                       : (size_t)slot_id[s];
          row[u] = rows + at * D;
        }
      }
      if (vec) {
        for (int c = lane; c < D / 4; c += 32) {
          const float4 qv = q4[c];
          float4 pv[kRowsPerWarp];
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u)
            if (row[u]) pv[u] = __ldg(reinterpret_cast<const float4*>(row[u]) + c);
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u) {
            if (!row[u]) continue;
            accum(metric, pv[u].x, qv.x, a[u], pp[u]);
            accum(metric, pv[u].y, qv.y, a[u], pp[u]);
            accum(metric, pv[u].z, qv.z, a[u], pp[u]);
            accum(metric, pv[u].w, qv.w, a[u], pp[u]);
          }
        }
      } else {
        for (int c = lane; c < D; c += 32) {
          const float qv = q_s[c];
          float pv[kRowsPerWarp];
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u)
            if (row[u]) pv[u] = __ldg(row[u] + c);
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u)
            if (row[u]) accum(metric, pv[u], qv, a[u], pp[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        if (e0 + u >= n_proc) break;                 // warp-uniform
        const float s_a = warp_sum(a[u]);
        float d;
        if (metric == kMetricL2) {
          d = sqrtf(s_a);
        } else if (metric == kMetricCosine) {
          const float s_pp = warp_sum(pp[u]);
          d = __fsub_rn(1.f, __fmul_rn(s_a, rsqrtf(fmaxf(__fmul_rn(qq, s_pp),
                                                          1e-30f))));
        } else {
          d = s_a;
        }
        if (lane == 0 && d < lower) {
          const int at = atomicAdd(&ctr[1], 1);
          new_d[at] = d;
          new_s[at] = proc[e0 + u];
        }
      }
    }
    __syncthreads();
    const int n_new = ctr[1];

    // --- rank the admitted by (d, slot); merge both queues by rank
    if (n_new > 0) {
      for (int e = tid; e < n_new; e += kThreads) {
        const float d = new_d[e];
        const int s = new_s[e];
        int rank = 0;
        for (int f = 0; f < n_new; ++f) {
          const float df = new_d[f];
          rank += df < d || (df == d && new_s[f] < s);
        }
        srt_d[rank] = d;
        srt_i[rank] = slot_id[s];
      }
      __syncthreads();
      for (int p = tid; p < ef; p += kThreads) {
        const int o = p + count_below(srt_d, n_new, rd[p]);
        if (o < ef) { rd_n[o] = rd[p]; ri_n[o] = ri[p]; }
      }
      for (int e = tid; e < n_new; e += kThreads) {
        const int o = e + count_at_or_below(rd, ef, srt_d[e]);
        if (o < ef) { rd_n[o] = srt_d[e]; ri_n[o] = srt_i[e]; }
      }
      const int rest = cap - T;          // incumbents after the pop
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
  }

  for (int p = tid; p < ef; p += kThreads) {
    out_d[(size_t)b * ef + p] = rd[p];
    out_i[(size_t)b * ef + p] = ri[p];
  }
  if (tid == 0) {
    out_hops[b] = hops;
    out_evals[b] = evals;
  }
}

}  // namespace

extern "C" {

// links i32[cap, maxM], counts i32[cap], rows f32[cap, D] (records = 0) or
// f32[cap, maxM, D] (records = 1), queries f32[B, D], entry_d f32[B] (read
// only when has_nodes), all contiguous; T <= cap, ef and cap <= 4096;
// smem_bytes from ops/cuda_graph._walk_smem_bytes.  Writes out_d f32[B,
// ef], out_i i32[B, ef], hops i32[B], evals i32[B].  Returns the launch's
// CUDA error (0 on success).
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
  const size_t smem = walk_smem_bytes(ef, cap, T, maxM, D);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (records) {
    err = cudaFuncSetAttribute(beam_walk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    beam_walk_kernel<true><<<B, kThreads, smem, stream>>>(
        links, counts, rows, queries, entry_d, has_nodes, D, maxM, T, ef,
        cap, metric, vec, out_d, out_i, hops, evals);
  } else {
    err = cudaFuncSetAttribute(beam_walk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    beam_walk_kernel<false><<<B, kThreads, smem, stream>>>(
        links, counts, rows, queries, entry_d, has_nodes, D, maxM, T, ef,
        cap, metric, vec, out_d, out_i, hops, evals);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
