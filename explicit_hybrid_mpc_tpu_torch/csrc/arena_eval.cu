// Fused serving evaluation over a multi-tenant leaf arena on Hopper
// (sm_90a): for each query row b of a mixed-tenant micro-batch,
//     thc     = min(max(th1[b], lb1[b]), ub1[b])      (certified-box clamp)
//     clamped = any(th1[b] != thc)
//     score_c = min_i  sum_j thc[j] * bary[i, j, c]   for c in [s_b, e_b)
//     c*      = first column with the largest score   (strict '>')
//     u[n]    = sum_i lam_i * U[i, c*, n],  cost = sum_i lam_i * V[i, c*]
// written as one int32 record per row: [val, col, cost, clamped, u...]
// (floats as their bits), so a batch costs one device->host copy.
//
// Replaces the TPU kernel explicit_hybrid_mpc_tpu/online/pallas_eval.py
// (_fused_kernel, launched by _fused_call from arena_eval_fused).  The TPU
// streamed a power-of-two column window through VMEM along a sequential
// grid axis, masked every column outside a row's extent to -BIG, and
// carried a running best (value, index, u, cost) in scratch, evaluating a
// one-hot candidate per tile.  Here nothing carries across blocks: ONE
// block owns ONE row and its 128 threads stride over that row's own
// extent only (no column window, no mask to apply: columns outside the
// extent are never read), each thread keeps its first maximum, and a
// block reduction under the total order (score desc, column asc) yields
// the first-match argmax of the TPU kernel.  The winner's lam is
// recomputed with the same fmaf order as its score rather than carried,
// so val, u and cost come from bitwise the arithmetic that chose it.
//
// Layout: bary (p+1, p+1, C), U (p+1, C, n_u), V (p+1, C) -- structure of
// arrays over columns, so the 32 lanes of a warp reading element (i, j)
// of 32 neighbouring columns touch one 128-byte line.  The kernel is
// instantiated per p+1 (2..8), which keeps the query in registers.
//
// Determinism: a row's result depends only on that row and the buffers
// (no atomics, fixed reduction order), so two launches on the same inputs
// are bitwise equal and a row's answer does not depend on the batch it
// rides in -- the torn-read audit of the serving path relies on both.
//
// NaN: a query with a NaN coordinate clamps to NaN (clamped), scores NaN
// in every column of its extent, and a NaN score is the largest -- the
// first column of the extent wins with val NaN, as torch.argmax and
// jnp.argmax order NaN in the plain versions -- so the row is unserved
// (val >= -tol is false) and never reaches a client as a certified
// control.  fminf would drop the NaN terms instead and score +inf.
//
// Precision: plain float32 FMAs, no tensor cores and no TF32 (the TPU
// kernel forced Precision.HIGHEST for the same reason: a reduced-precision
// dot costs about three digits of containment margin).
//
// What bounds it: a row's work is (p+1)^2 FMAs per column of its own
// extent.  At a serving batch (tens to hundreds of rows) the launch is
// latency-bound; one block per row spreads each row's extent over 128
// lanes so the batch finishes in about (extent / 128) column steps.  At
// large batches every row re-reads its tenant's columns from L2 (no reuse
// across rows of one tenant): the first lever when large batches matter.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;   // threads per block = per query row
constexpr int kWarps = kThreads / 32;
constexpr int kHead = 4;        // record words before u
constexpr float kBig = 1e30f;   // score of a masked column

// The order of the first-match argmax: score descending with NaN above
// every number, then column ascending.
__device__ __forceinline__ bool better(float v, int c, float bv, int bc) {
  if (v != v) return bv == bv || c < bc;
  if (bv != bv) return false;
  return v > bv || (v == bv && c < bc);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
arena_eval_kernel(const float* __restrict__ q, const int* __restrict__ ext,
                  const float* __restrict__ bary,
                  const float* __restrict__ U, const float* __restrict__ V,
                  int B, int C, int nu, int* __restrict__ rec) {
  __shared__ float s_val[kWarps];
  __shared__ int s_col[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // Clamp in the jnp.clip order (max with lb, then min with ub; a NaN
  // query stays NaN).  Column p of th1/lb1/ub1 is 1, so the homogeneous
  // coordinate passes unchanged.
  float thc[K];
  bool moved = false;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float t = q[(size_t)b * K + j];
    const float lo = q[((size_t)B + b) * K + j];
    const float hi = q[((size_t)2 * B + b) * K + j];
    float c = t < lo ? lo : t;
    c = c > hi ? hi : c;
    thc[j] = c;
    moved |= (t != c);
  }

  const int s = max(ext[2 * b], 0);
  const int e = min(ext[2 * b + 1], C);
  float best = -INFINITY;
  int best_c = INT_MAX;
  for (int c = s + tid; c < e; c += kThreads) {
    float sc = INFINITY;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j)
        acc = fmaf(thc[j], __ldg(bary + (size_t)(i * K + j) * C + c), acc);
      sc = (acc < sc || acc != acc) ? acc : sc;   // a NaN term sticks
    }
    // Columns ascend: keeps this thread's first maximum (first NaN).
    if (sc > best || (sc != sc && best == best)) {
      best = sc;
      best_c = c;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oc = __shfl_down_sync(0xffffffffu, best_c, off);
    if (better(ov, oc, best, best_c)) {
      best = ov;
      best_c = oc;
    }
  }
  if ((tid & 31) == 0) {
    s_val[tid >> 5] = best;
    s_col[tid >> 5] = best_c;
  }
  __syncthreads();
  best = s_val[0];
  best_c = s_col[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    if (better(s_val[w], s_col[w], best, best_c)) {
      best = s_val[w];
      best_c = s_col[w];
    }
  // Nothing live above the mask value (an empty extent): the masked
  // score at column 0, as an argmax over the masked row gives.
  if (best == best && !(best > -kBig)) {
    best = -kBig;
    best_c = 0;
  }

  float lam[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      acc = fmaf(thc[j], bary[(size_t)(i * K + j) * C + best_c], acc);
    lam[i] = acc;
  }
  int* r = rec + (size_t)b * (kHead + nu);
  for (int n = tid; n < nu; n += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
      acc = fmaf(lam[i], U[((size_t)i * C + best_c) * nu + n], acc);
    r[kHead + n] = __float_as_int(acc);
  }
  if (tid == 0) {
    float cost = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
      cost = fmaf(lam[i], V[(size_t)i * C + best_c], cost);
    r[0] = __float_as_int(best);
    r[1] = best_c;
    r[2] = __float_as_int(cost);
    r[3] = moved ? 1 : 0;
  }
}

template <int K>
void launch(const float* q, const int* ext, const float* bary,
            const float* U, const float* V, int B, int C, int nu, int* rec,
            cudaStream_t stream) {
  arena_eval_kernel<K><<<B, kThreads, 0, stream>>>(q, ext, bary, U, V, B, C,
                                                   nu, rec);
}

}  // namespace

extern "C" {

int arena_eval_f32(const float* q, const int* ext, const float* bary,
                   const float* U, const float* V, int B, int C, int p,
                   int nu, int* rec, void* stream) {
  if (B <= 0) return 0;
  if (C <= 0 || nu < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p + 1) {
    case 2: launch<2>(q, ext, bary, U, V, B, C, nu, rec, st); break;
    case 3: launch<3>(q, ext, bary, U, V, B, C, nu, rec, st); break;
    case 4: launch<4>(q, ext, bary, U, V, B, C, nu, rec, st); break;
    case 5: launch<5>(q, ext, bary, U, V, B, C, nu, rec, st); break;
    case 6: launch<6>(q, ext, bary, U, V, B, C, nu, rec, st); break;
    case 7: launch<7>(q, ext, bary, U, V, B, C, nu, rec, st); break;
    case 8: launch<8>(q, ext, bary, U, V, B, C, nu, rec, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* arena_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
