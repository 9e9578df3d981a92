// Streaming point location over a PWA controller's leaf table on Hopper
// (sm_90a): for each query theta, the leaf l with the largest
//     score[l] = min_i  th1 . bary[l, i, :],     th1 = [theta; 1],
// first leaf on ties, returned as (leaf int32, score float32).
//
// Replaces the TPU kernel explicit_hybrid_mpc_tpu/online/pallas_eval.py
// (_locate_kernel, launched by _locate_call from locate/evaluate).  The
// TPU streamed leaf tiles through VMEM along a sequential grid axis and
// carried a running (best, index) in scratch.  Hopper blocks run in no
// order, so here ONE block owns a tile of queries and walks every leaf
// tile itself: the leaves go through shared memory in increasing order,
// each thread keeps its query's running best in registers, and a strict
// '>' keeps the first maximum -- the TPU kernel's first-match argmax
// (strict '>' across tiles) without a second pass.  Nothing of size
// (queries x leaves) is ever materialized.
//
// Precision: plain float32 FMAs, no tensor cores and no TF32 -- a
// reduced-precision dot costs about three digits of containment margin
// (the reference forces Precision.HIGHEST for the same reason).
//
// The table layout is the f32 cast of the leaf table's bary_M,
// (L, p+1, p+1) row-major, so no padded vertices or leaves are needed:
// the kernel is instantiated per p+1 (2..8) and takes the leaf count.
//
// What bounds it: operations.  Every query scores every leaf, (p+1)^2
// FMAs each -- 65,536 queries x 11,670 leaves x 9 = 6.9e9 FMAs at the
// pendulum's table -- while the table (420 KB) is re-read from L2 and
// shared memory, never from device memory after the first pass.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 8;      // p + 1 <= 8
constexpr int kQueries = 128; // queries (threads) per block
constexpr int kLeafTile = 128;

// K = p + 1 is a template parameter so th[] and the dot products stay
// in registers, fully unrolled.
template <int K>
__global__ void locate_kernel(const float* __restrict__ theta,
                              const float* __restrict__ bary, int B, int L,
                              int* __restrict__ leaf_out,
                              float* __restrict__ score_out) {
  constexpr int KK = K * K;
  __shared__ float tile[kLeafTile * KK];
  const int b = blockIdx.x * kQueries + threadIdx.x;
  float th[K];
#pragma unroll
  for (int j = 0; j < K - 1; ++j)
    th[j] = b < B ? theta[(size_t)b * (K - 1) + j] : 0.f;
  th[K - 1] = 1.f;
  float best = -INFINITY;
  int best_idx = 0;
  for (int l0 = 0; l0 < L; l0 += kLeafTile) {
    const int nl = min(kLeafTile, L - l0);
    __syncthreads();
    for (int e = threadIdx.x; e < nl * KK; e += kQueries)
      tile[e] = bary[(size_t)l0 * KK + e];
    __syncthreads();
    for (int l = 0; l < nl; ++l) {
      const float* m = tile + l * KK;
      float sc = 1e30f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) acc = fmaf(th[j], m[i * K + j], acc);
        sc = fminf(sc, acc);
      }
      if (sc > best) {
        best = sc;
        best_idx = l0 + l;
      }
    }
  }
  if (b < B) {
    leaf_out[b] = best_idx;
    score_out[b] = best;
  }
}

template <int K>
void launch(const float* theta, const float* bary, int B, int L,
            int* leaf_out, float* score_out, cudaStream_t stream) {
  const int blocks = (B + kQueries - 1) / kQueries;
  locate_kernel<K><<<blocks, kQueries, 0, stream>>>(theta, bary, B, L,
                                                   leaf_out, score_out);
}

}  // namespace

extern "C" {

int locate_f32(const float* theta, const float* bary, int B, int L, int p,
               int* leaf_out, float* score_out, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p + 1) {
    case 2: launch<2>(theta, bary, B, L, leaf_out, score_out, st); break;
    case 3: launch<3>(theta, bary, B, L, leaf_out, score_out, st); break;
    case 4: launch<4>(theta, bary, B, L, leaf_out, score_out, st); break;
    case 5: launch<5>(theta, bary, B, L, leaf_out, score_out, st); break;
    case 6: launch<6>(theta, bary, B, L, leaf_out, score_out, st); break;
    case 7: launch<7>(theta, bary, B, L, leaf_out, score_out, st); break;
    case 8: launch<8>(theta, bary, B, L, leaf_out, score_out, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int locate_max_k() { return kMaxK; }

const char* locate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
