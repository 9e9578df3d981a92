// Streaming point location over a PWA controller's leaf table on Hopper
// (sm_90a): for each query theta, the leaf l with the largest
//     score[l] = min_i  th1 . bary[l, i, :],     th1 = [theta; 1],
// first leaf on ties (a NaN score ranks first: leaf_score.cuh), returned
// as (leaf int32, score float32).
//
// Replaces the TPU kernel explicit_hybrid_mpc_tpu/online/pallas_eval.py
// (_locate_kernel, launched by _locate_call from locate/evaluate).  The
// TPU streamed leaf tiles through VMEM along a sequential grid axis and
// carried a running (best, index) in scratch.  Here the grid is
// (query blocks) x (leaf splits): each block takes 512 queries and one
// contiguous range of leaves, and a second small kernel merges the
// splits' (score, leaf) partials under the argmax's total order (a split
// covers lower leaves than the next, so the merge keeps the first
// maximum).  Nothing of size (queries x leaves) is ever materialized.
//
// What bounds it: operations.  Every query scores every leaf, (p+1)^2
// FMAs each -- 65,536 queries x 11,670 leaves x 9 = 6.9e9 FMAs at the
// pendulum's table -- while the table (420 KB) stays in L2.  So the
// design is about instruction issue, not bytes:
// - each thread holds 4 queries, so every table value it reads from
//   shared memory feeds 4 FMAs;
// - the leaf tile sits in shared memory with each vertex row padded to
//   16 bytes, so a leaf of the pendulum (3 x 3) comes in as three 128-bit
//   broadcast loads; the next tile is copied in by cp.async while this
//   one is scored (double buffer);
// - the running best costs one NaN-propagating max per (query, leaf):
//   the loop keeps only the maximum of each group of 16 leaves and the
//   group where the best so far lies; at the end the thread scores that
//   one group again (the same arithmetic, so the same bits) to find the
//   leaf;
// - splitting the leaves across blocks keeps the card full when 512
//   queries a block leave fewer blocks than SMs (launch plan in
//   online/locate.py, plan_splits).
//
// Precision: plain float32 FMAs, no tensor cores and no TF32 -- a
// reduced-precision dot costs about three digits of containment margin
// (the reference forces Precision.HIGHEST for the same reason).  Each
// score is the fmaf chain j ascending from 0 and the vertex minimum, so
// on a query with finite coordinates leaf and score are bitwise those of
// the one-query-per-thread kernel this replaced (whose fminf from 1e30
// ranked a NaN query inside leaf 0 with score 1e30).
//
// The table layout is the f32 cast of the leaf table's bary_M,
// (L, p+1, p+1) row-major; the kernel is instantiated per p+1 (2..8).

#include <cuda_runtime.h>
#include <math.h>

#include "leaf_score.cuh"

namespace {

using leaf_score::better;
using leaf_score::max_nan;
using leaf_score::min_nan;
using leaf_score::row_dot;

constexpr int kMaxK = 8;         // p + 1 <= 8
constexpr int kThreads = 128;
constexpr int kQ = 4;            // queries per thread
constexpr int kBlockQueries = kThreads * kQ;
constexpr int kGroup = 16;       // leaves per running-max group

template <int K>
struct Shape {
  static constexpr int KK = K * K;
  static constexpr int KP = K <= 4 ? 4 : 8;      // padded row, floats
  static constexpr int LEAF = K * KP;            // padded leaf, floats
  static constexpr int TILE = K <= 4 ? 128 : 64; // leaves per stage
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy leaves [l0, l0 + nl) into a padded shared tile (asynchronously).
template <int K>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ bary,
                                           int l0, int nl) {
  using S = Shape<K>;
  const float* src = bary + (size_t)l0 * S::KK;
  for (int e = threadIdx.x; e < nl * S::KK; e += kThreads) {
    const int l = e / S::KK, r = e - l * S::KK;
    const int i = r / K, j = r - i * K;
    cp_async4(dst + l * S::LEAF + i * S::KP + j, src + e);
  }
}

// A leaf's score for one query: the fmaf chain per vertex row, then the
// NaN-propagating minimum over the rows.
template <int K>
__device__ __forceinline__ float score(const float (&th)[K],
                                       const float (&m)[K][K]) {
  float sc = row_dot<K>(th, m[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) sc = min_nan(sc, row_dot<K>(th, m[i]));
  return sc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
locate_kernel(const float* __restrict__ theta,
              const float* __restrict__ bary, int B, int L, int per_split,
              int splits, int* __restrict__ leaf_out,
              float* __restrict__ score_out, int* __restrict__ part_leaf,
              float* __restrict__ part_score) {
  using S = Shape<K>;
  __shared__ __align__(16) float tile[2][S::TILE * S::LEAF];
  const int split = blockIdx.y;
  const int l_begin = min(split * per_split, L);
  const int l_end = min(l_begin + per_split, L);

  float th[kQ][K];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int b = blockIdx.x * kBlockQueries + q * kThreads + threadIdx.x;
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
      th[q][j] = b < B ? theta[(size_t)b * (K - 1) + j] : 0.f;
    th[q][K - 1] = 1.f;
  }
  float best[kQ];
  int best_group[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    best[q] = -INFINITY;
    best_group[q] = -1;
  }

  int buf = 0;
  if (l_begin < l_end)
    stage_tile<K>(tile[0], bary, l_begin, min(S::TILE, l_end - l_begin));
  cp_async_commit();
  for (int l0 = l_begin; l0 < l_end; l0 += S::TILE) {
    const int nl = min(S::TILE, l_end - l0);
    const int next = l0 + S::TILE;
    if (next < l_end)
      stage_tile<K>(tile[buf ^ 1], bary, next, min(S::TILE, l_end - next));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* t = tile[buf];
    for (int g0 = 0; g0 < nl; g0 += kGroup) {
      float gmax[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) gmax[q] = -INFINITY;
      auto leaf = [&](int l) {
        const float4* m4 = reinterpret_cast<const float4*>(t + l * S::LEAF);
        float m[K][K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
#pragma unroll
          for (int h = 0; h < S::KP / 4; ++h) {
            const float4 v = m4[i * (S::KP / 4) + h];
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (4 * h + c < K) m[i][4 * h + c] = vv[c];
          }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          gmax[q] = max_nan(gmax[q], score<K>(th[q], m));
      };
      if (g0 + kGroup <= nl) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) leaf(g0 + k);
      } else {
        for (int k = g0; k < nl; ++k) leaf(k);
      }
      // Strictly better than every earlier group (a NaN beats numbers,
      // and only the first NaN group counts).
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (gmax[q] > best[q] || (gmax[q] != gmax[q] && best[q] == best[q])) {
          best[q] = gmax[q];
          best_group[q] = l0 + g0;
        }
    }
    __syncthreads();   // every thread is done with tile[buf]
    buf ^= 1;
  }
  cp_async_wait<0>();

  // The first leaf of the best group that scores the group's maximum (a
  // NaN when the maximum is NaN), scored again from global memory.
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int b = blockIdx.x * kBlockQueries + q * kThreads + threadIdx.x;
    int leaf = l_begin;
    float sc = -INFINITY;
    if (best_group[q] >= 0) {
      const int ge = min(best_group[q] + kGroup, l_end);
      for (int l = best_group[q]; l < ge; ++l) {
        float m[K][K];
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int j = 0; j < K; ++j)
            m[i][j] = __ldg(bary + (size_t)l * S::KK + i * K + j);
        const float s = score<K>(th[q], m);
        if (s == best[q] || (best[q] != best[q] && s != s)) {
          leaf = l;
          sc = s;
          break;
        }
      }
    }
    if (b < B) {
      if (splits == 1) {
        leaf_out[b] = leaf;
        score_out[b] = sc;
      } else {
        part_leaf[(size_t)split * B + b] = leaf;
        part_score[(size_t)split * B + b] = sc;
      }
    }
  }
}

// Join the splits' partials in split order under the argmax's order.
__global__ void locate_merge(const int* __restrict__ part_leaf,
                             const float* __restrict__ part_score,
                             int splits, int B, int* __restrict__ leaf_out,
                             float* __restrict__ score_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float bv = part_score[b];
  int bl = part_leaf[b];
  for (int s = 1; s < splits; ++s) {
    const float v = part_score[(size_t)s * B + b];
    const int l = part_leaf[(size_t)s * B + b];
    if (better(v, l, bv, bl)) {
      bv = v;
      bl = l;
    }
  }
  leaf_out[b] = bl;
  score_out[b] = bv;
}

template <int K>
void launch(const float* theta, const float* bary, int B, int L,
            int per_split, int splits, int* leaf_out, float* score_out,
            int* part_leaf, float* part_score, cudaStream_t stream) {
  const dim3 grid((B + kBlockQueries - 1) / kBlockQueries, splits);
  locate_kernel<K><<<grid, kThreads, 0, stream>>>(
      theta, bary, B, L, per_split, splits, leaf_out, score_out, part_leaf,
      part_score);
}

}  // namespace

extern "C" {

// splits x per_split must cover the L leaves (online/locate.py,
// plan_splits); with splits > 1, part_leaf/part_score hold splits x B
// partials.
int locate_f32(const float* theta, const float* bary, int B, int L, int p,
               int per_split, int splits, int* leaf_out, float* score_out,
               int* part_leaf, float* part_score, void* stream) {
  if (B <= 0) return 0;
  if (splits < 1 || L < 0 || (long long)per_split * splits < L ||
      (splits > 1 && (part_leaf == nullptr || part_score == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p + 1) {
#define LOCATE_CASE(K)                                                     \
  case K:                                                                  \
    launch<K>(theta, bary, B, L, per_split, splits, leaf_out, score_out,   \
              part_leaf, part_score, st);                                  \
    break;
    LOCATE_CASE(2) LOCATE_CASE(3) LOCATE_CASE(4) LOCATE_CASE(5)
    LOCATE_CASE(6) LOCATE_CASE(7) LOCATE_CASE(8)
#undef LOCATE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  locate_merge<<<(B + 255) / 256, 256, 0, st>>>(part_leaf, part_score,
                                                 splits, B, leaf_out,
                                                 score_out);
  return (int)cudaGetLastError();
}

int locate_max_k() { return kMaxK; }

int locate_block_queries() { return kBlockQueries; }

const char* locate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
