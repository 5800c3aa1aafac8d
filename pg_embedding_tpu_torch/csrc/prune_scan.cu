// The sequential keep/reject scan of the diversity prune (Malkov's
// getNeighborsByHeuristic) for a batch of candidate sets in one launch, for
// NVIDIA Hopper (sm_90a): one warp per set.
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
// B = 256, C = 128).  The result is comparisons of the same float32 values,
// so it equals the twin bit for bit.
//
// What bounds it on an H100: the bytes it must read, at most B C C 4 of
// pair plus d_s, valid_s and order (13 B C), over 3.35 TB/s: ~5 us at B =
// 256, C = 128.  Only the pairs a scan tests are read (the kept r's of each
// taken-or-tested j), so the data's own count is far lower.  The scan is a
// dependent chain of C steps per set, each waiting on its loads from the
// row pair[b, order[j]], so latency sets the time.
//
// Design: one warp per set, 4 sets a block.  The warp reads d_s, valid_s
// and order 32 candidates at a time (one coalesced load each) and passes
// them from lane to lane with shuffles; at step j the lanes test the kept
// r's in parallel (lane l the kept l, l + 32, ...) and __any_sync decides.
// The kept list (original positions) lives in shared memory, nn entries a
// warp.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
prune_scan_kernel(const float* __restrict__ d_s,
                  const unsigned char* __restrict__ valid_s,
                  const long long* __restrict__ order,
                  const float* __restrict__ pair,
                  const unsigned char* __restrict__ do_prune, int B, int C,
                  int nn, unsigned char* __restrict__ kept_mask,
                  int* __restrict__ kept_count) {
  extern __shared__ int kept_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;                    // a whole warp; no block barrier
  int* kept = kept_s + (size_t)warp * nn;
  const bool prune = do_prune[b] != 0;
  const size_t row0 = (size_t)b * C;
  const float* pb = pair + row0 * C;
  int k = 0;
  for (int j0 = 0; j0 < C; j0 += 32) {
    const int jl = j0 + lane;
    const float dl = jl < C ? d_s[row0 + jl] : 0.f;
    const int vl = jl < C ? valid_s[row0 + jl] : 0;
    const int ol = jl < C ? (int)order[row0 + jl] : 0;
    const int n = min(32, C - j0);
    for (int t = 0; t < n; ++t) {
      const float d = __shfl_sync(kFull, dl, t);
      const int v = __shfl_sync(kFull, vl, t);
      const int o = __shfl_sync(kFull, ol, t);
      bool take = v && k < nn;                         // warp-uniform
      if (take && prune) {
        bool conflict = false;
        const float* pr = pb + (size_t)o * C;
        for (int r = lane; r < k; r += 32) conflict |= pr[kept[r]] < d;
        take = !__any_sync(kFull, conflict);
      }
      if (lane == 0) kept_mask[row0 + j0 + t] = take;
      if (take) {
        if (lane == 0) kept[k] = o;
        ++k;
        __syncwarp();
      }
    }
  }
  if (lane == 0) kept_count[b] = k;
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
  const size_t smem = sizeof(int) * (size_t)kWarpsPerBlock * nn;
  if (B <= 0 || C <= 0 || nn <= 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  prune_scan_kernel<<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      d_s, valid_s, order, pair, do_prune, B, C, nn, kept_mask, kept_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
