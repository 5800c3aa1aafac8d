// The sequential keep/reject scan of the diversity prune (Malkov's
// getNeighborsByHeuristic) for a batch of candidate sets in one launch, for
// NVIDIA Hopper (sm_90a): one warp per set, driven by the kept neighbours.
//
// Replaces: pg_embedding_tpu/core/build.py::_prune_heuristic (:44), the
// jax.lax.fori_loop (:87) that the JAX insert program vmaps over a batch
// (:457) and over the back-link re-prunes (:158, :250).  Its plain twin is
// core/build._prune_scan_plain; the sorts before the scan and the
// compaction after it stay torch ops.  Given the candidates sorted
// nearest-first (d_s f32[B, C], valid_s bool[B, C], order i64[B, C], the
// sort's permutation of the original candidate positions), the pairwise
// distances pair f32[B, C, C] in the ORIGINAL candidate order, do_prune
// bool[B] and nn, it scans j = 0..C-1 in order:
//   conflict_j = some kept r has pair[b, order[j], order[r]] < d_s[b, j]
//   take_j     = valid_s[j] && (!conflict_j || !do_prune) && kept < nn
// and writes kept_mask bool[B, C] and kept_count i32[B].  Reading pair
// through order replaces the twin's two [B, C, C] gathers (16.8 MB each at
// B = 256, C = 128).  The result is comparisons of the same float32 values
// (row: the candidate, column: the keeper, as the twin reads them; pair is
// not assumed symmetric), so it equals the twin bit for bit.
//
// What bounds it on an H100: the bytes it must read, the pairs the scan
// tests (each kept r of each tested j) plus d_s, valid_s and order (13 B C)
// over 3.35 TB/s: ~0.4 us for an insert batch (B = 256, C = 128, nn = 16).
// Nothing near that is reached: a set's scan is a chain of dependent
// rounds, so latency sets the time.
//
// Design: the loop runs over KEEPERS, not candidates.  A round finds the
// next keeper, the first "alive" candidate (valid, not yet rejected) after
// the last one, and then tests every alive later candidate against it at
// once: the lanes issue their loads of pair[b, order[i], order[k]]
// together and clear the rejected bits with one ballot a 32-candidate word.
// A set costs at most nn dependent rounds (16 at the insert shape) instead
// of C steps.  Up to 256 candidates (every set the main path makes) each
// lane keeps the set's alive and kept words (warp-uniform) and its own
// candidates' order and d_s in registers, so a round is a few ALU ops, one
// shuffle (the keeper's original position) and the keeper's column loads;
// wider sets keep the words in shared memory and read order and d_s
// through L1.  Sets that are not pruned take their first nn valid
// candidates from the bits, with no round at all.  Two warps a block
// spread B = 256 sets over 128 SMs.  (The back-link re-prunes, C = maxM +
// 1, run inside csrc/connect_batch.cu; here they reach this kernel only
// through the plain twin's wiring.)
//
// What holds it back now: each round still waits on one L2 latency for
// the keeper's column, and a set's rounds are a chain.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kSmemLimit = 232448;
constexpr int kWordsPerPass = 8;     // candidate words tested per load pass
constexpr unsigned kFull = 0xffffffffu;

// Phase clocks of the instrumented build (-DPG_PROFILE): lane 0 of each
// warp sums its laps and adds them to g_prune_prof at the end.
enum { kLapInit, kLapSearch, kLapReject, kLapWrite, kLaps };
#ifdef PG_PROFILE
// the laps' cycles, then rounds, sets, pruned sets
__device__ unsigned long long g_prune_prof[kLaps + 3];
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
  __device__ void flush(int lane, int rounds, bool prune) {
    if (lane) return;
    for (int i = 0; i < kLaps; ++i)
      atomicAdd(&g_prune_prof[i], (unsigned long long)acc[i]);
    atomicAdd(&g_prune_prof[kLaps], (unsigned long long)rounds);
    atomicAdd(&g_prune_prof[kLaps + 1], 1ull);
    atomicAdd(&g_prune_prof[kLaps + 2], (unsigned long long)prune);
  }
};
#else
struct Laps {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void flush(int, int, bool) {}
};
#endif

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The first candidate after ``pos`` whose alive bit is set, or -1
// (warp-uniform).
__device__ __forceinline__ int next_alive(const unsigned* alive, int W,
                                          int pos, int lane) {
  const int start = pos + 1, w_start = start >> 5;
  for (int w0 = w_start; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    unsigned bits = w < W ? alive[w] : 0u;
    if (w == w_start) bits &= ~lanes_below(start & 31);
    const unsigned m = __ballot_sync(kFull, bits != 0u);
    if (m) {
      const int src = __ffs(m) - 1;
      const unsigned word = __shfl_sync(kFull, bits, src);
      return ((w0 + src) << 5) + __ffs(word) - 1;
    }
  }
  return -1;
}

// Shared memory a warp: its alive and kept words.
__host__ __device__ size_t words_bytes(int C) {
  return 8 * (size_t)((C + 31) / 32);
}

// The lowest r set bits of m.
__device__ __forceinline__ unsigned first_bits(unsigned m, int r) {
  unsigned rest = m;
  for (; r > 0; --r) rest &= rest - 1u;
  return m ^ rest;
}

// Sets of up to 32 kWords candidates (C <= 256): every lane holds the
// set's alive and kept words (warp-uniform) and, for its own candidates j
// = 32 u + lane, order[j] and d_s[j], all in registers, so a round is a
// shuffle (the keeper's original position) and the keeper's column loads.
template <int kWords>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
prune_scan_regs(const float* __restrict__ d_s,
                const unsigned char* __restrict__ valid_s,
                const long long* __restrict__ order,
                const float* __restrict__ pair,
                const unsigned char* __restrict__ do_prune, int B, int C,
                int nn, unsigned char* __restrict__ kept_mask,
                int* __restrict__ kept_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;                    // a whole warp; no block barrier
  Laps laps;
  laps.start();
  const bool prune = do_prune[b] != 0;
  const size_t row0 = (size_t)b * C;
  const float* pb = pair + row0 * C;
  const float kInf = __int_as_float(0x7f800000);
  int o[kWords];
  float d[kWords];
  unsigned alive[kWords], kept[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int j = 32 * u + lane;
    const bool in = j < C;
    o[u] = in ? (int)__ldg(order + row0 + j) : 0;
    d[u] = in ? __ldg(d_s + row0 + j) : 0.f;
    alive[u] = __ballot_sync(kFull, in && valid_s[row0 + j]);
    kept[u] = 0u;
  }
  laps.lap(kLapInit);

  int k = 0, rounds = 0;
  if (!prune) {
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int c = __popc(alive[u]);
      kept[u] = first_bits(alive[u], min(c, nn - k));
      k += min(c, nn - k);
    }
  } else {
    int pos = -1;
    while (k < nn) {
      // the next keeper: the lowest alive bit after pos
      int j = -1;
#pragma unroll
      for (int u = kWords - 1; u >= 0; --u) {
        const int sh = pos - 32 * u;   // bits of word u at or below pos
        const unsigned after =
            sh < 0 ? ~0u : (sh >= 31 ? 0u : ~0u << (sh + 1));
        const unsigned m = alive[u] & after;
        if (m) j = 32 * u + __ffs(m) - 1;
      }
      laps.lap(kLapSearch);
      if (j < 0) break;
      int oj = 0;
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        if (u == (j >> 5)) {
          kept[u] |= 1u << (j & 31);
          oj = o[u];
        }
      }
      pos = j;
      ++rounds;
      if (++k == nn) break;
      // reject every alive candidate after j that keeper j is closer to
      const int ok = __shfl_sync(kFull, oj, j & 31);
      float pv[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        pv[u] = kInf;
        if (((alive[u] >> lane) & 1u) && 32 * u + lane > j)
          pv[u] = __ldg(pb + (size_t)o[u] * C + ok);
      }
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        alive[u] &= ~__ballot_sync(kFull, pv[u] < d[u]);
      laps.lap(kLapReject);
    }
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int j = 32 * u + lane;
    if (j < C) kept_mask[row0 + j] = (kept[u] >> lane) & 1u;
  }
  if (lane == 0) kept_count[b] = k;
  laps.lap(kLapWrite);
  laps.flush(lane, rounds, prune);
}

// Sets of more than 256 candidates: the alive and kept words in shared
// memory, order and d_s read through L1.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
prune_scan_kernel(const float* __restrict__ d_s,
                  const unsigned char* __restrict__ valid_s,
                  const long long* __restrict__ order,
                  const float* __restrict__ pair,
                  const unsigned char* __restrict__ do_prune, int B, int C,
                  int nn, unsigned char* __restrict__ kept_mask,
                  int* __restrict__ kept_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;                    // a whole warp; no block barrier
  Laps laps;
  laps.start();
  const int W = (C + 31) >> 5;
  unsigned* alive = reinterpret_cast<unsigned*>(smem + warp * words_bytes(C));
  unsigned* kept = alive + W;
  const bool prune = do_prune[b] != 0;
  const size_t row0 = (size_t)b * C;
  const float* pb = pair + row0 * C;
  const float kInf = __int_as_float(0x7f800000);

  // alive = valid, a word per 32 candidates, 8 words' loads in flight
  for (int w0 = 0; w0 < W; w0 += kWordsPerPass) {
    int v[kWordsPerPass];
#pragma unroll
    for (int u = 0; u < kWordsPerPass; ++u) {
      const int j = ((w0 + u) << 5) + lane;
      v[u] = j < C ? valid_s[row0 + j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kWordsPerPass; ++u) {
      const unsigned m = __ballot_sync(kFull, v[u] != 0);
      if (lane == 0 && w0 + u < W) {
        alive[w0 + u] = m;
        kept[w0 + u] = 0u;
      }
    }
  }
  __syncwarp();
  laps.lap(kLapInit);

  int k = 0, rounds = 0;
  if (!prune) {
    // the first nn valid candidates
    for (int w = 0; w < W && k < nn; ++w) {
      const int c = __popc(alive[w]);
      if (lane == 0) kept[w] = first_bits(alive[w], min(c, nn - k));
      k += min(c, nn - k);
    }
  } else {
    int pos = -1;
    while (k < nn) {
      const int j = next_alive(alive, W, pos, lane);
      laps.lap(kLapSearch);
      if (j < 0) break;
      if (lane == 0) kept[j >> 5] |= 1u << (j & 31);
      pos = j;
      ++rounds;
      if (++k == nn) break;
      // reject every alive candidate after j that keeper j is closer to
      const int ok = (int)__ldg(order + row0 + j);
      for (int w0 = (j + 1) >> 5; w0 < W; w0 += kWordsPerPass) {
        float pv[kWordsPerPass], dv[kWordsPerPass];
#pragma unroll
        for (int u = 0; u < kWordsPerPass; ++u) {
          const int w = w0 + u, i = (w << 5) + lane;
          pv[u] = kInf;
          dv[u] = 0.f;
          if (w < W && i > j && ((alive[w] >> lane) & 1u)) {
            const int o = (int)__ldg(order + row0 + i);
            dv[u] = __ldg(d_s + row0 + i);
            pv[u] = __ldg(pb + (size_t)o * C + ok);
          }
        }
#pragma unroll
        for (int u = 0; u < kWordsPerPass; ++u) {
          const unsigned rej = __ballot_sync(kFull, pv[u] < dv[u]);
          if (lane == 0 && rej) alive[w0 + u] &= ~rej;
        }
      }
      __syncwarp();
      laps.lap(kLapReject);
    }
  }
  __syncwarp();
  for (int j = lane; j < C; j += 32)
    kept_mask[row0 + j] = (kept[j >> 5] >> (j & 31)) & 1u;
  if (lane == 0) kept_count[b] = k;
  laps.lap(kLapWrite);
  laps.flush(lane, rounds, prune);
}

// The kernel for sets of W words: in registers up to kMaxRegWords words
// (rounded up to a power of two), else in shared memory.
constexpr int kMaxRegWords = 8;

const void* pick_kernel(int W) {
  if (W <= 1) return (const void*)prune_scan_regs<1>;
  if (W <= 2) return (const void*)prune_scan_regs<2>;
  if (W <= 4) return (const void*)prune_scan_regs<4>;
  if (W <= kMaxRegWords) return (const void*)prune_scan_regs<8>;
  return (const void*)prune_scan_kernel;
}

}  // namespace

extern "C" {

// d_s f32[B, C], valid_s bool[B, C], order i64[B, C], pair f32[B, C, C],
// do_prune bool[B], all contiguous; writes kept_mask bool[B, C] and
// kept_count i32[B].  Returns the launch's CUDA error (0 on success).
int prune_scan(const float* d_s, const unsigned char* valid_s,
               const long long* order, const float* pair,
               const unsigned char* do_prune, int B, int C, int nn,
               unsigned char* kept_mask, int* kept_count, void* stream_ptr) {
  if (B <= 0 || C <= 0 || nn <= 0) return (int)cudaErrorInvalidValue;
  const int W = (C + 31) / 32;
  const size_t smem =
      W <= kMaxRegWords ? 0 : kWarpsPerBlock * words_bytes(C);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const void* fn = pick_kernel(W);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&d_s, &valid_s, &order, &pair, &do_prune,
                  &B, &C, &nn, &kept_mask, &kept_count};
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (int)cudaLaunchKernel(fn, dim3(blocks), dim3(kWarpsPerBlock * 32),
                               args, smem,
                               static_cast<cudaStream_t>(stream_ptr));
}

#ifdef PG_PROFILE
// Copies the instrumented build's counters (the laps' cycles, rounds, sets,
// pruned sets) to ``out`` and zeroes them.
int prune_scan_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prune_prof,
                                         sizeof(g_prune_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kLaps + 3] = {};
  return (int)cudaMemcpyToSymbol(g_prune_prof, zero, sizeof(zero));
}
#endif

}  // extern "C"
