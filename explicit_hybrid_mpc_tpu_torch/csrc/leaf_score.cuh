// What the point-location kernels (locate.cu, arena_eval.cu) share: the
// order of their first-match argmax and the NaN-propagating minimum of a
// leaf's score.
//
// A leaf's (a column's) score for a homogeneous query th1 is
//     score = min_i  sum_j th1[j] * bary[i, j]
// with each sum an fmaf chain over j ascending from 0.  A NaN term makes
// the score NaN, and a NaN score ranks above every number, as torch.argmax
// and jnp.argmax rank it in the plain versions: a query with a NaN
// coordinate then lands on the first leaf with score NaN and is never
// reported inside.  fminf would drop the NaN terms instead.

#pragma once

#include <cuda_runtime.h>

namespace leaf_score {

// The argmax order: score descending with NaN above every number, then
// leaf (column) ascending.  A total order, so any merge order of partial
// results gives the same winner.
__device__ __forceinline__ bool better(float v, int c, float bv, int bc) {
  if (v != v) return bv == bv || c < bc;
  if (bv != bv) return false;
  return v > bv || (v == bv && c < bc);
}

// min and max that return NaN when either operand is NaN (PTX min.NaN /
// max.NaN, sm_80 and later: one instruction, as fminf/fmaxf; on numbers
// they are fminf/fmaxf).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One vertex row's sum: th[0]*m[0] + ... + th[K-1]*m[K-1] as the fmaf
// chain j ascending from 0 (both kernels and their parents use exactly
// this chain, so every score is bitwise the same in all of them).
template <int K>
__device__ __forceinline__ float row_dot(const float (&th)[K],
                                         const float* m) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) acc = fmaf(th[j], m[j], acc);
  return acc;
}

}  // namespace leaf_score
