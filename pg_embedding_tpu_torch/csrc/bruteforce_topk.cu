// Fused exact k-NN sweep for NVIDIA Hopper (sm_90a): distance scores and a
// running per-query top-k in one pass over the corpus, so the [B, N]
// distance matrix never reaches device memory.
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
// kernel takes it); queries are always float32.  A bf16 row is widened to
// float32 exactly in registers, and everything after the load is the same.
//
// What bounds it on an H100: at 128-d and a 1024-query batch the sweep
// reads 512 MB of corpus per 1M rows (0.15 ms at 3.35 TB/s) and does
// 1.3e11 multiply-adds (about 4 ms at the 67 TFLOP/s float32 peak), so it
// is bound by float32 FMA issue and by the shared-memory traffic that feeds
// it, not by device memory.  The scores are float32 FMA on the CUDA cores:
// more exact than the TPU's bf16x3 split (~2^-18 relative); a single TF32
// tensor-core pass (~2^-11) would reorder true neighbours.
//
// Design:
//  * Pass 1, grid (query tiles) x (corpus splits S).  S is chosen so the
//    grid holds >= 2 blocks per SM.  Blocks that share a split run side by
//    side (blockIdx.x is fastest), so each corpus tile comes from HBM about
//    once and from L2 for the other query tiles.
//  * A block holds 8 warps and QT = 8 * QPW queries.  It streams its split
//    in tiles of 128 rows x 32 dims through shared memory; warp w owns
//    queries w*QPW.. and lane l owns rows l, l+32, l+64, l+96 of the tile,
//    so a thread keeps QPW x 4 scores in registers and reads both operands
//    as float4 (conflict-free: the row stride is padded to 36 floats).
//    |p|^2 comes from the same registers.  Ragged rows and dims are masked
//    at load, so any D and N work and the corpus is never padded or copied.
//    A bf16 corpus halves the bytes read; when its rows are 16-byte aligned
//    (D % 8 == 0) a thread loads 8 dims in one 16-byte load, else one at a
//    time, and widens them into the same float32 shared-memory tile.
//  * Selection stays inside the warp that owns the query: a ballot of
//    scores below the current k-th finds the rare candidates (a tile with
//    none costs one ballot), and each is inserted into a sorted list of
//    k_run entries in shared memory by a warp-parallel count and shift.
//  * Pass 2 merges the S sorted partial lists of each query, one warp per
//    query, applies sqrt for L2 and writes [B, k_run] directly.
// No wgmma or TMA yet: right and simple first.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                 // corpus rows per tile
constexpr int kRowsPerLane = kTileN / 32;
constexpr int kTileD = 32;                  // dims per shared-memory chunk
constexpr int kPStride = kTileD + 4;        // padded row stride (floats)
constexpr int kMaxSplits = 128;
constexpr int kMaxK = 1024;
constexpr int kMinRowsPerSplit = 2048;
constexpr int kMergeWarps = 4;
constexpr int kMetricL2 = 0;
constexpr int kMetricCosine = 1;
constexpr unsigned kFull = 0xffffffffu;

// (d, id) order; id -1 (an empty slot) sorts after every real id
__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && (unsigned)ia < (unsigned)ib);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int QPW>
size_t sweep_smem_bytes(int k_run) {
  const int qt = kWarps * QPW;
  return sizeof(float) * ((size_t)qt * kTileD + (size_t)kTileN * kPStride +
                          qt) +
         (sizeof(float) + sizeof(int)) * (size_t)qt * k_run;
}

// One kTileN x kTileD corpus tile into shared memory as float32, zero past
// row_end and D.  float32 corpus: a warp reads 32 consecutive floats of a
// row.
__device__ __forceinline__ void load_tile(const float* __restrict__ p,
                                          float* p_s, int tile, int row_end,
                                          int d0, int D, bool /*vec*/,
                                          int tid) {
  for (int e = tid; e < kTileN * kTileD; e += kThreads) {
    const int r = e / kTileD, c = e % kTileD;
    const int row = tile + r, col = d0 + c;
    p_s[r * kPStride + c] =
        (row < row_end && col < D) ? p[(size_t)row * D + col] : 0.f;
  }
}

// bf16 corpus, as its raw 16-bit patterns: thread e owns 8 consecutive dims
// of one row, read in one 16-byte load when ``vec`` (rows 16-byte aligned),
// else one by one.  A bf16 value is the high half of its float32, so the
// widening is a shift and exact.
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void load_tile(const uint16_t* __restrict__ p,
                                          float* p_s, int tile, int row_end,
                                          int d0, int D, bool vec, int tid) {
  constexpr int kVec = 8;
  constexpr int kPerRow = kTileD / kVec;
  for (int e = tid; e < kTileN * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    const int row = tile + r, col = d0 + c;
    float v[kVec];
    if (vec && row < row_end && col < D) {    // D % 8 == 0: all 8 in range
      const uint4 u =
          *reinterpret_cast<const uint4*>(p + (size_t)row * D + col);
      v[0] = bf16_bits_to_float(u.x & 0xffffu);
      v[1] = __uint_as_float(u.x & 0xffff0000u);
      v[2] = bf16_bits_to_float(u.y & 0xffffu);
      v[3] = __uint_as_float(u.y & 0xffff0000u);
      v[4] = bf16_bits_to_float(u.z & 0xffffu);
      v[5] = __uint_as_float(u.z & 0xffff0000u);
      v[6] = bf16_bits_to_float(u.w & 0xffffu);
      v[7] = __uint_as_float(u.w & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[j] = (row < row_end && col + j < D)
                   ? bf16_bits_to_float(p[(size_t)row * D + col + j])
                   : 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(&p_s[r * kPStride + c]);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <int QPW, typename T>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ q, const T* __restrict__ p,
             const unsigned char* __restrict__ del, int B, int n_rows, int D,
             bool vec, int k_run, int metric, int rows_per_split,
             float* __restrict__ part_d, int* __restrict__ part_i) {
  constexpr int QT = kWarps * QPW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);          // [QT][kTileD]
  float* p_s = q_s + QT * kTileD;                       // [kTileN][kPStride]
  float* qn_s = p_s + kTileN * kPStride;                // [QT]
  float* list_d = qn_s + QT;                            // [QT][k_run]
  int* list_i = reinterpret_cast<int*>(list_d + QT * k_run);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_rows, row_begin + rows_per_split);

  for (int e = tid; e < QT * k_run; e += kThreads) {
    list_d[e] = CUDART_INF_F;
    list_i[e] = -1;
  }
  for (int i = 0; i < QPW; ++i) {
    const int qi = q0 + warp * QPW + i;
    float s = 0.f;
    if (qi < B)
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)qi * D + d];
        s = fmaf(v, v, s);
      }
    s = warp_sum(s);
    if (lane == 0) qn_s[warp * QPW + i] = s;
  }
  __syncthreads();

  for (int tile = row_begin; tile < row_end; tile += kTileN) {
    float acc[QPW][kRowsPerLane];
    float pn[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      pn[j] = 0.f;
#pragma unroll
      for (int i = 0; i < QPW; ++i) acc[i][j] = 0.f;
    }

    for (int d0 = 0; d0 < D; d0 += kTileD) {
      load_tile(p, p_s, tile, row_end, d0, D, vec, tid);
      for (int e = tid; e < QT * kTileD; e += kThreads) {
        const int r = e / kTileD, c = e % kTileD;
        const int qi = q0 + r, col = d0 + c;
        q_s[r * kTileD + c] =
            (qi < B && col < D) ? q[(size_t)qi * D + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kTileD; c += 4) {
        float4 pv[kRowsPerLane];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          pv[j] = *reinterpret_cast<const float4*>(
              &p_s[(lane + 32 * j) * kPStride + c]);
          pn[j] = fmaf(pv[j].x, pv[j].x, pn[j]);
          pn[j] = fmaf(pv[j].y, pv[j].y, pn[j]);
          pn[j] = fmaf(pv[j].z, pv[j].z, pn[j]);
          pn[j] = fmaf(pv[j].w, pv[j].w, pn[j]);
        }
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              &q_s[(warp * QPW + i) * kTileD + c]);
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            acc[i][j] = fmaf(qv.x, pv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv.y, pv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv.z, pv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv.w, pv[j].w, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // selection: warp w alone touches the lists of its own queries
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const int ql = warp * QPW + i;
      if (q0 + ql >= B) continue;                        // warp-uniform
      const float qn = qn_s[ql];
      float* ld = list_d + ql * k_run;
      int* li = list_i + ql * k_run;
      float kth = ld[k_run - 1];
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int row = tile + lane + 32 * j;
        float s = metric == kMetricL2
                      ? fmaxf(pn[j] + qn - 2.f * acc[i][j], 0.f)
                      : 1.f - acc[i][j] * rsqrtf(fmaxf(pn[j] * qn, 1e-30f));
        if (row >= row_end || (del != nullptr && del[row] != 0))
          s = CUDART_INF_F;
        unsigned mask = __ballot_sync(kFull, s < kth);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float dv = __shfl_sync(kFull, s, src);
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
  }

  for (int i = 0; i < QPW; ++i) {
    const int ql = warp * QPW + i;
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
             int* __restrict__ out_i) {
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
    }
    __syncwarp();
  }
}

int queries_per_warp(int k_run) { return k_run <= 512 ? 4 : 2; }

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

template <int QPW, typename T>
cudaError_t launch_sweep(const float* q, const T* p,
                         const unsigned char* del, int B, int n_rows, int D,
                         int k_run, int metric, int S, float* part_d,
                         int* part_i, cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes<QPW>(k_run);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<QPW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_per_split =
      ceil_div(ceil_div(n_rows, S), kTileN) * kTileN;
  // 16-byte row loads need 16-byte rows and a 16-byte aligned corpus
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0;
  dim3 grid(ceil_div(B, kWarps * QPW), S);
  sweep_kernel<QPW, T><<<grid, kThreads, smem, stream>>>(
      q, p, del, B, n_rows, D, vec, k_run, metric, rows_per_split, part_d,
      part_i);
  return cudaGetLastError();
}

template <typename T>
int run_topk(const float* q, const T* p, const unsigned char* del, int B,
             int n_rows, int D, int k_run, int metric, int S, float* part_d,
             int* part_i, float* out_d, int* out_i, void* stream_ptr) {
  if (B <= 0 || n_rows < 0 || D <= 0 || k_run < 1 || k_run > kMaxK ||
      S < 1 || S > kMaxSplits ||
      (metric != kMetricL2 && metric != kMetricCosine))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err =
      queries_per_warp(k_run) == 4
          ? launch_sweep<4, T>(q, p, del, B, n_rows, D, k_run, metric, S,
                               part_d, part_i, stream)
          : launch_sweep<2, T>(q, p, del, B, n_rows, D, k_run, metric, S,
                               part_d, part_i, stream);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<ceil_div(B, kMergeWarps), kMergeWarps * 32, 0, stream>>>(
      part_d, part_i, B, S, k_run, metric, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of corpus splits S for a launch; the caller allocates the
// [S, B, k_run] partial lists.
int bruteforce_topk_splits(int B, int n_rows, int k_run) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int q_tiles = ceil_div(B, kWarps * queries_per_warp(k_run));
  int s = ceil_div(2 * sms, q_tiles);
  s = std::min(s, ceil_div(n_rows, kMinRowsPerSplit));
  return std::max(1, std::min(s, kMaxSplits));
}

const char* bruteforce_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q f32[B, D], p f32[n_rows.., D] (row-major, contiguous), del u8[n_rows..]
// or null; out_d f32[B, k_run], out_i i32[B, k_run].  Returns the CUDA
// error of the launches (0 on success).
int bruteforce_topk(const float* q, const float* p, const unsigned char* del,
                    int B, int n_rows, int D, int k_run, int metric, int S,
                    float* part_d, int* part_i, float* out_d, int* out_i,
                    void* stream_ptr) {
  return run_topk(q, p, del, B, n_rows, D, k_run, metric, S, part_d, part_i,
                  out_d, out_i, stream_ptr);
}

// The same with p bf16[n_rows.., D] (its raw 16-bit patterns).
int bruteforce_topk_bf16(const float* q, const void* p,
                         const unsigned char* del, int B, int n_rows, int D,
                         int k_run, int metric, int S, float* part_d,
                         int* part_i, float* out_d, int* out_i,
                         void* stream_ptr) {
  return run_topk(q, static_cast<const uint16_t*>(p), del, B, n_rows, D,
                  k_run, metric, S, part_d, part_i, out_d, out_i, stream_ptr);
}

}  // extern "C"
