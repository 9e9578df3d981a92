// Fused serving evaluation over a multi-tenant leaf arena on Hopper
// (sm_90a): for each query row b of a mixed-tenant micro-batch,
//     thc     = min(max(th1[b], lb1[b]), ub1[b])      (certified-box clamp)
//     clamped = any(th1[b] != thc)
//     score_c = min_i  sum_j thc[j] * bary[i, j, c]   for c in [s_b, e_b)
//     c*      = first column with the largest score   (NaN ranks first)
//     u[n]    = sum_i lam_i * U[i, c*, n],  cost = sum_i lam_i * V[i, c*]
// written as one int32 record per row: [val, col, cost, clamped, u...]
// (floats as their bits), so a batch costs one device->host copy.
//
// Replaces the TPU kernel explicit_hybrid_mpc_tpu/online/pallas_eval.py
// (_fused_kernel, launched by _fused_call from arena_eval_fused).  The TPU
// streamed a power-of-two column window through VMEM along a sequential
// grid axis, masked every column outside a row's extent to -BIG, and
// carried a running best (value, index, u, cost) in scratch.  Here
// columns outside a row's extent are never read, and the work is cut two
// ways so that the serving run's batches -- about 16 rows over 4 tenants
// of ~11,670 columns each, at most 256 -- fill the card:
//
// - Row tiles.  The host orders the rows by extent and groups rows of one
//   extent into tiles of up to kTileRows (online/fused.py, plan_batch: 2
//   rows at a serving batch, 8 at large ones).  A thread loads a column's
//   (p+1)^2 values once and scores it against every row of its tile,
//   whose clamped queries sit in registers, so the L2 traffic of a large
//   batch falls by the tile's row count.
// - Column chunks.  Each tile's extent is cut into `chunks` equal pieces
//   of at least 512 columns (one batch of four column loads a thread),
//   one block each: a 16-row batch (8 tiles) runs on 184 blocks instead
//   of 16.  Each block leaves one (score, column) partial per row; the
//   last block of a tile to finish (one thread writes the partials,
//   fences and takes a ticket from a per-tile counter) joins its tile's
//   partials with a warp per row, evaluates u and cost at the winners,
//   writes the records and has reset the counter to 0 for the next
//   launch.  With one chunk the block evaluates directly.
//
// A serving batch is latency-bound: its time is a chain of dependent
// steps (the tile, then the queries and columns, the block's argmax, the
// partials and the ticket, the join, the winners' columns), each a round
// trip to L2 or a barrier; the design keeps that chain to one pass.
//
// Determinism: a column's score is the same fmaf chain (j ascending from
// 0, then the vertex minimum with NaN sticking) whatever the tiling, and
// the argmax order (leaf_score.cuh) is a total order, so the winner does
// not depend on the merge order; the winner's lam, u and cost are
// recomputed in a fixed order.  A row's record is therefore bitwise the
// same alone or in any batch, under any chunking, in every launch (the
// torn-read audit of the serving path relies on it) -- and bitwise that
// of the one-block-per-row kernel this replaced.
//
// NaN: a query with a NaN coordinate clamps to NaN (clamped), scores NaN
// in every column of its extent, and a NaN score is the largest -- the
// first column of the extent wins with val NaN, as torch.argmax and
// jnp.argmax order NaN in the plain versions -- so the row is unserved
// (val >= -tol is false) and never reaches a client as a certified
// control.
//
// Precision: plain float32 FMAs, no tensor cores and no TF32 (the TPU
// kernel forced Precision.HIGHEST for the same reason).
//
// What bounds it: at a serving batch the work is small (16 rows x 11,670
// columns x 9 FMAs) and the bound is reading the live extents' bary once
// (1.7 MB): the launch is latency-bound, which the column chunks attack.
// At 65,536 rows it is operations (6.9e9 FMAs), with the L2 traffic cut
// by the row tiles.
//
// Layout: bary (p+1, p+1, C), U (p+1, C, n_u), V (p+1, C) -- structure of
// arrays over columns, so the 32 lanes of a warp reading element (i, j)
// of 32 neighbouring columns touch one 128-byte line.  The kernel is
// instantiated per p+1 (2..8).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "leaf_score.cuh"

namespace {

using leaf_score::better;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;    // rows of one extent per block
constexpr int kMaxChunks = 64;  // column chunks per tile
constexpr int kHead = 4;        // record words before u
constexpr float kBig = 1e30f;   // score of a masked column

// A tile, as kTileWords int32 words: {n rows, s, e, unused, row ids...}:
// rows of the batch that share the extent [s, e).
constexpr int kTileWords = 4 + kTileRows;

// Columns a thread loads before it scores them (one batch of loads in
// flight); fewer at large p+1, where they would cost registers.
template <int K>
struct ColBatch {
  static constexpr int value = K <= 4 ? 4 : 1;
};

// The parent kernel's vertex minimum, NaN sticking: keeps the bits of
// every score (a -0 and a +0 stay apart) exactly as it had them.
__device__ __forceinline__ float vmin(float sc, float acc) {
  return (acc < sc || acc != acc) ? acc : sc;
}

__device__ __forceinline__ void take_if_better(float v, int c, float& bv,
                                               int& bc) {
  if (better(v, c, bv, bc)) {
    bv = v;
    bc = c;
  }
}

// Block-wide argmax of each of the tile's rows (the rows' butterflies
// interleaved); the result for row r is in (s_val[r], s_col[r]).
__device__ __forceinline__ void block_argmax(float (&best)[kTileRows],
                                             int (&col)[kTileRows], int nr,
                                             float (*w_val)[kTileRows],
                                             int (*w_col)[kTileRows],
                                             float* s_val, int* s_col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      if (r < nr) {
        const float ov = __shfl_down_sync(0xffffffffu, best[r], off);
        const int oc = __shfl_down_sync(0xffffffffu, col[r], off);
        take_if_better(ov, oc, best[r], col[r]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      w_val[warp][r] = best[r];
      w_col[warp][r] = col[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    float bv = w_val[0][r];
    int bc = w_col[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) take_if_better(w_val[w][r], w_col[w][r],
                                                    bv, bc);
    s_val[r] = bv;
    s_col[r] = bc;
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kThreads)
arena_eval_kernel(const float* __restrict__ q, const int* __restrict__ tiles,
                  const float* __restrict__ bary,
                  const float* __restrict__ U, const float* __restrict__ V,
                  int B, int C, int nu, int chunks, int* __restrict__ counter,
                  float* __restrict__ part_val, int* __restrict__ part_col,
                  int* __restrict__ rec) {
  constexpr int NB = ColBatch<K>::value;
  __shared__ float w_val[kWarps][kTileRows];
  __shared__ int w_col[kWarps][kTileRows];
  __shared__ float s_val[kTileRows];
  __shared__ int s_col[kTileRows];
  __shared__ float s_thc[kTileRows][K];
  __shared__ int s_row[kTileRows];
  __shared__ int s_moved[kTileRows];
  __shared__ int s_last;

  const int t = blockIdx.x / chunks;
  const int g = blockIdx.x - t * chunks;
  const int* tile = tiles + (size_t)t * kTileWords;
  const int nr = min(tile[0], kTileRows);
  const int s = max(tile[1], 0);
  const int len = max(min(tile[2], C) - s, 0);
  const int c0 = s + (int)((long long)len * g / chunks);
  const int c1 = s + (int)((long long)len * (g + 1) / chunks);

  // Clamp in the jnp.clip order (max with lb, then min with ub; a NaN
  // query stays NaN).  Column p of th1/lb1/ub1 is 1, so the homogeneous
  // coordinate passes unchanged.  Every thread holds every row's query.
  // The row ids are read whatever the tile's row count (its unused words
  // are 0), so the queries' loads wait for one load only.  A row id
  // outside [0, B) (a plan that is not this batch's) reads row B - 1's
  // query and writes no record.
  int row[kTileRows];
  float thc[kTileRows][K];
  bool moved[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    row[r] = tile[4 + r];
    moved[r] = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float c = 0.f;
      if (r < nr) {
        const int b = min((unsigned)row[r], (unsigned)(B - 1));
        const float v = q[(size_t)b * K + j];
        const float lo = q[((size_t)B + b) * K + j];
        const float hi = q[((size_t)2 * B + b) * K + j];
        c = v < lo ? lo : v;
        c = c > hi ? hi : c;
        moved[r] |= (v != c);
      }
      thc[r][j] = c;
    }
  }

  float best[kTileRows];
  int best_c[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    best[r] = -INFINITY;
    best_c[r] = INT_MAX;
  }
  // NB columns a thread at a time: their loads go out together, then
  // they are scored in ascending order.
  for (int cb = c0 + threadIdx.x; cb < c1; cb += NB * kThreads) {
    float m[NB][K][K];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int c = cb + u * kThreads;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          m[u][i][j] = c < c1 ? __ldg(bary + (size_t)(i * K + j) * C + c)
                              : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int c = cb + u * kThreads;
      if (c >= c1) break;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        if (r < nr) {
          float sc = INFINITY;
#pragma unroll
          for (int i = 0; i < K; ++i)
            sc = vmin(sc, leaf_score::row_dot<K>(thc[r], m[u][i]));
          // Columns ascend: keeps this thread's first maximum (first
          // NaN).
          if (sc > best[r] || (sc != sc && best[r] == best[r])) {
            best[r] = sc;
            best_c[r] = c;
          }
        }
      }
    }
  }
  block_argmax(best, best_c, nr, w_val, w_col, s_val, s_col);

  if (chunks > 1) {
    // Leave this chunk's partials; the tile's last block goes on.  One
    // thread writes them, fences and takes a ticket (the pattern of the
    // CUDA samples' threadFenceReduction).
    const size_t base = (size_t)t * kTileRows * chunks;
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) {
        part_val[base + r * chunks + g] = s_val[r];
        part_col[base + r * chunks + g] = s_col[r];
      }
      __threadfence();
      s_last = atomicAdd(counter + t, 1) == chunks - 1;
      if (s_last) {
        __threadfence();
        counter[t] = 0;
      }
    }
    __syncthreads();
    if (!s_last) return;
    // Warp w joins rows w, w + 4, ...: lane k takes chunks k and k + 32,
    // then a butterfly under the argmax's order (a total order, so the
    // tree's shape does not matter).
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < nr; r += kWarps) {
      float bv = -INFINITY;
      int bc = INT_MAX;
#pragma unroll
      for (int h = 0; h < kMaxChunks / 32; ++h) {
        const int k = lane + 32 * h;
        if (k < chunks)
          take_if_better(__ldcg(part_val + base + r * chunks + k),
                         __ldcg(part_col + base + r * chunks + k), bv, bc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_if_better(__shfl_xor_sync(0xffffffffu, bv, off),
                       __shfl_xor_sync(0xffffffffu, bc, off), bv, bc);
      if (lane == 0) {
        s_val[r] = bv;
        s_col[r] = bc;
      }
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
      for (int j = 0; j < K; ++j) s_thc[r][j] = thc[r][j];
      s_row[r] = row[r];
      s_moved[r] = moved[r];
    }
  }
  __syncthreads();

  // Evaluate at the winners, every (row, output) pair at once: output n
  // < nu is u[n], output nu the record's head (val, col, cost, clamped).
  for (int k = threadIdx.x; k < nr * (nu + 1); k += kThreads) {
    const int r = k / (nu + 1), n = k - r * (nu + 1);
    if ((unsigned)s_row[r] >= (unsigned)B) continue;
    float bv = s_val[r];
    int bc = s_col[r];
    // Nothing live above the mask value (an empty extent): the masked
    // score at column 0, as an argmax over the masked row gives.
    if (bv == bv && !(bv > -kBig)) {
      bv = -kBig;
      bc = 0;
    }
    float lam[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j)
        acc = fmaf(s_thc[r][j], bary[(size_t)(i * K + j) * C + bc], acc);
      lam[i] = acc;
    }
    int* out = rec + (size_t)s_row[r] * (kHead + nu);
    if (n < nu) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
        acc = fmaf(lam[i], U[((size_t)i * C + bc) * nu + n], acc);
      out[kHead + n] = __float_as_int(acc);
    } else {
      float cost = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
        cost = fmaf(lam[i], V[(size_t)i * C + bc], cost);
      out[0] = __float_as_int(bv);
      out[1] = bc;
      out[2] = __float_as_int(cost);
      out[3] = s_moved[r];
    }
  }
}

template <int K>
void launch(const float* q, const int* tiles, const float* bary,
            const float* U, const float* V, int B, int C, int nu,
            int n_tiles, int chunks, int* counter, float* part_val,
            int* part_col, int* rec, cudaStream_t stream) {
  arena_eval_kernel<K><<<n_tiles * chunks, kThreads, 0, stream>>>(
      q, tiles, bary, U, V, B, C, nu, chunks, counter, part_val, part_col,
      rec);
}

}  // namespace

extern "C" {

// tiles: n_tiles x kTileWords words {n, s, e, unused, n row ids}: every
// row of the batch in one tile of at most arena_eval_tile_rows() rows
// that share the extent [s, e); with chunks > 1, counters: n_tiles words
// that are 0 (the kernel leaves them 0 again), and partials: n_tiles x
// tile rows x chunks values, then as many columns (online/fused.py,
// plan_batch and Scratch).
int arena_eval_f32(const float* q, const int* tiles, int n_tiles,
                   int chunks, const float* bary, const float* U,
                   const float* V, int B, int C, int p, int nu,
                   int* counters, int* partials, int* rec, void* stream) {
  if (B <= 0) return 0;
  if (C <= 0 || nu < 0 || n_tiles <= 0 || n_tiles > B || chunks < 1 ||
      chunks > kMaxChunks ||
      (chunks > 1 && (counters == nullptr || partials == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t n_part = (size_t)n_tiles * kTileRows * chunks;
  float* part_val = (float*)partials;
  int* part_col = partials ? partials + n_part : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p + 1) {
#define ARENA_CASE(K)                                                    \
  case K:                                                                \
    launch<K>(q, tiles, bary, U, V, B, C, nu, n_tiles, chunks, counters, \
              part_val, part_col, rec, st);                              \
    break;
    ARENA_CASE(2) ARENA_CASE(3) ARENA_CASE(4) ARENA_CASE(5)
    ARENA_CASE(6) ARENA_CASE(7) ARENA_CASE(8)
#undef ARENA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int arena_eval_tile_rows() { return kTileRows; }

int arena_eval_max_chunks() { return kMaxChunks; }

const char* arena_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
