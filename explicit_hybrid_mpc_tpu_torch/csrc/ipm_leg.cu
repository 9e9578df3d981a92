// Fixed-iteration Mehrotra predictor-corrector leg for a batch of small
// dense QPs,  min 1/2 z'Qz + q'z  s.t.  Az <= b,  on Hopper (sm_90a).
//
// Replaces the TPU kernel explicit_hybrid_mpc_tpu/oracle/pallas_ipm.py
// (_make_leg_kernel, launched by solve_tiles): the same n_iter
// iterations of the same algebra -- residuals and mu, the KKT matrix
// M = Q + A' diag(lam/s) A, the ridge Cholesky in the clamped
// column form of _chol_factor, forward/backward substitution for the
// predictor and the corrector, fraction-to-boundary steps, and the
// centering sigma = (mu_aff/mu)^3 -- with the shared leg constants
// (ridge 1e-7 / 1e-10, slack floor 1e-8 / 1e-12, Cholesky floor
// 1e-30 / 1e-300) in float and double.  The plain torch version is
// ipm_leg_torch in oracle/ipm_leg.py.
//
// What bounds it: neither bytes nor operations.  A QP moves ~3 KB and
// does ~10^5 flops per leg at the pendulum's shapes (nz 5-8, nc 35-39),
// and the offline build launches it at 8-2,048 QPs (mostly <= 256), so
// the card is mostly empty and the time is the dependent chain of one
// QP's iteration.  The design shortens that chain:
//
//  - One warp per QP, one warp per block (small launches spread over
//    every SM).  Lane l owns constraint rows l, l+32, ... (ROWS <= 4)
//    and keeps their rows of A, b, s, lam, r_p, D = lam/s, 1/s, 1/lam
//    and the step vectors in registers.
//  - A'lam, A't and the lower triangle of A'DA are lane-local partial
//    sums over the lane's own rows (independent FMAs), combined with mu
//    in ONE warp reduction: a reduce-scatter butterfly (each of the 5
//    __shfl_xor_sync stages halves the values a lane carries) and an
//    all-gather through a small shared buffer, so every lane ends with
//    every total.  A z and A dz are lane-local.
//  - The Cholesky factor and the four triangular solves (predictor and
//    corrector share the factor) run redundantly in every lane, in
//    registers, unrolled for a compile-time NZ <= 8: no shuffle, no
//    __syncwarp, no shared memory inside them.  Every lane holds the
//    same sums bit for bit (addition commutes), so the lanes agree.
//  - Reciprocals instead of divisions on the chain: 1/s and 1/lam once
//    per row, the pivot as min(rsqrt(max(C_jj, 0)), 1/floor) (the
//    reciprocal of the reference's max(sqrt(C_jj), floor)), which is
//    also 1/L_jj for all four solves where the clamp is inactive, and
//    sigma's mu_aff/mu as a product with 1/nc and 1/mu.  The only
//    divisions left are the fraction-to-boundary ratios, independent
//    across rows; their primal and dual minima each take two
//    __reduce_min_sync on the bit patterns instead of 5 shuffles.
//  - nz 9..32 with nc <= 128 (the satellite's QPs: nz 24-31, nc
//    14-104) takes the general path (ipm_leg_mid).  nz is not padded to
//    8 (0 * NaN would leak NaN into live rows and change the sums).  At
//    these shapes A is 3-33 KB in f64 and an iteration ~10^5 flops, and
//    the build launches K 64-1,728 (at most ~5 QPs an SM), so what
//    bounds it is again one QP's dependent chain: nz pivots and 4 nz
//    substitution steps an iteration, each a shuffle and a few f64
//    operations of ~15-30 cycles, and the assembly of A'DA over nc
//    rows.  Measured on an H100 (chip_smoke.k1_general_only, clock64()
//    split at nz 24 / nc 96, 12 iterations, K 64): 15.9 us an
//    iteration -- factor 3.7, the four substitutions 4.2, assembly 2.6,
//    the rest on the rows (residuals, steps, step lengths, sigma).  The
//    design:
//    * One warp a QP and a block.  Lane i owns variable i (z_i, r_d_i,
//      row i of C and of its factor L, in registers) and constraint
//      rows i, i + 32, ... (s, lam, b and the steps in registers); A,
//      Q and C (then L, by column) stay in shared memory, A loaded
//      once by cp.async for all n_iter iterations.  The loops are
//      unrolled to an nz bucket (16, 24, 32); a column the bucket may
//      lack is skipped by a select or a uniform branch, never summed as
//      zero times a value that may be NaN.
//    * The factor broadcasts two columns' pivot entries a round; every
//      lane forms both pivot reciprocals min(rsqrt(max(C_jj, 0)),
//      1/floor) itself, scales its entries, and applies both rank-1
//      downdates after one exchange through shared memory: no
//      division, no nz^2 sweep, 1/L_ii formed once after the factor.
//    * A substitution step is a shuffle of the pivot row's value times
//      1/L_jj and one FMA a lane: forward with the lane's row of L in
//      registers, backward with its column from shared memory.
//    * A'DA (f64) on the FP64 tensor cores: DMMA m8n8k4 tiles of the
//      lower triangle over four rows a step, A' the A operand, D A the
//      B operand, A'lam and A't one more block column; A's rows are
//      staged so that a fragment's loads and the lanes' own rows both
//      fall in distinct banks.  f32 sums register tiles on the FMA
//      units.  A'DA's entries each run over the rows in a fixed order.
//    * The row passes as the register path: 1/s and 1/lam once a row,
//      the step ratios by reciprocal, their minima by
//      __reduce_min_sync on the bit patterns, mu and mu_aff one
//      butterfly each; the corrector's A't as four interleaved chains
//      joined in a fixed order.
//  - Every larger shape (nz > 32 or nc > 128; the quadrotor's QPs are
//    nz 60-65, nc 360-366, its pruned ones nz 60-65, nc 49-55) takes the
//    large path (ipm_leg_large): one block of 256 threads per QP.  A QP
//    does ~2 MFLOP an iteration there and A alone is 190 KB in f64, so
//    the bound is operations (the assembly of A'DA, nc nz (nz+1)/2
//    FMAs); but the build launches it at K 8-1,024, two QPs an SM at
//    most, so what bounds it is one QP's iteration: the dependent chain
//    of the factor and the four substitutions (nz steps each), the
//    block-wide reductions between the passes over the rows, and the
//    assembly's shared-memory traffic.  The design:
//    * The Cholesky and the four substitutions run on one warp over the
//      packed triangle in shared memory (the other warps form Q z + q
//      meanwhile, then wait at a barrier).  The pivot is
//      min(rsqrt(max(C_jj, 0)), 1/floor), also 1/L_jj for the solves
//      where the clamp is inactive (as the register path).  The factor
//      is left-looking: a lane's rows of column j are C_aj less the
//      reference's downdates L_ak L_jk, k < j, in its order, as one FMA
//      chain of loads only, then scaled; a __syncwarp a column.  A
//      substitution step loads its factor entries first, then is a
//      __shfl_sync broadcast of the pivot row's value and one FMA a
//      row, lane l holding rows l, l+32, ... in registers, no lane
//      branching: no division and no block barrier in the chain.
//    * Block sums are a __shfl_xor_sync butterfly a warp, then the 8
//      warp partials in order; the primal and dual step minima share
//      one exchange and one barrier: 9 barriers an iteration besides
//      two a chunk of A.
//    * The row passes form 1/s and 1/lam once a row an iteration, D =
//      lam (1/s), the step ratios with the reciprocal of the step, and
//      spread each row's dot product over 4-8 lanes joined by shuffles:
//      no lane runs a serial chain of divisions.
//    * A'DA: A streams from global memory (L2) in chunks of 32 rows,
//      double-buffered with cp.async so the next chunk loads while this
//      one is summed.  Each thread owns 4x4 register tiles of the
//      lower triangle (tile indices computed once a launch) and sums
//      them over the chunk's rows in order: 8 shared loads for 16 FMAs,
//      each group of 4 columns padded by one so that the groups a
//      warp reads fall in distinct banks.
//      A'lam and A't go to the threads the tiles leave.
//    Every sum runs in a fixed order (rows in order for each entry, a
//    fixed tree across lanes and warps), so a QP's result does not
//    depend on its batch.  Its ceiling is the shared memory of one
//    block (large_smem) and the registers of one warp (nz <= 256); at
//    (65, 366) in f64 a QP takes 96 KB, so two QPs share an SM.
//
// A QP depends only on its own inputs -- no cross-QP reduction, no
// padding across QPs -- so its result is bitwise independent of K and
// of its position in the batch.  All n_iter iterations run in one
// launch; operands are read once and results written once.
//
// NaN semantics follow the JAX reference: max/min propagate NaN (a
// diverging infeasible QP must stay non-finite so it classifies as
// not converged), and the substitutions multiply by an explicit zero
// outside the triangle exactly as the reference does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// The register and general paths take nz <= kMaxNz, nc <= kMaxNc;
// the large path everything else, within its own ceiling.
constexpr int kMaxNz = 32;
constexpr int kMaxNc = 128;
constexpr int kLargeThreads = 256;
constexpr int kLargeRows = 32;                // rows of A in a chunk
constexpr int kLargeWarps = kLargeThreads / 32;
constexpr int kTile = 4;                      // A'DA register tile edge
constexpr long long kMaxSmem = 232448;        // 227 KB, one block
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Leg;
template <> struct Leg<float> {
  static __device__ constexpr float reg() { return 1e-7f; }
  static __device__ constexpr float tiny() { return 1e-8f; }
  static __device__ constexpr float floor() { return 1e-30f; }
  static __device__ constexpr float mu_floor() { return 1e-12f; }
  static __device__ float inf() { return __int_as_float(0x7f800000); }
};
template <> struct Leg<double> {
  static __device__ constexpr double reg() { return 1e-10; }
  static __device__ constexpr double tiny() { return 1e-12; }
  static __device__ constexpr double floor() { return 1e-300; }
  static __device__ constexpr double mu_floor() { return 1e-12; }
  static __device__ double inf() {
    return __longlong_as_double(0x7ff0000000000000ll);
  }
};

__device__ __forceinline__ float rroot(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rroot(double a) { return ::rsqrt(a); }
__device__ __forceinline__ float recip(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double recip(double a) { return __drcp_rn(a); }

template <typename T> __device__ __forceinline__ bool is_nan(T a) {
  return a != a;
}
// NaN-propagating max / min (jnp.maximum / jnp.minimum semantics).
template <typename T> __device__ __forceinline__ T pmax(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T pmin(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? a : b));
}
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Min over the warp of values that are >= +0, +inf or NaN (the
// fraction-to-boundary ratios): their bit patterns order as unsigned
// integers, so two __reduce_min_sync (high word, then low word among
// the lanes that hold the least high word) find it; a NaN anywhere
// gives NaN, as jnp.minimum does.
__device__ __forceinline__ double warp_min_nonneg(double v) {
  const unsigned long long b = __double_as_longlong(v);
  const unsigned hi = __reduce_min_sync(kFull, unsigned(b >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, unsigned(b >> 32) == hi ? unsigned(b) : 0xffffffffu);
  if (__any_sync(kFull, is_nan(v)))
    return __longlong_as_double(0x7ff8000000000000ll);
  return __longlong_as_double(
      (long long)(((unsigned long long)hi << 32) | lo));
}
__device__ __forceinline__ float warp_min_nonneg(float v) {
  const unsigned m = __reduce_min_sync(kFull, __float_as_uint(v));
  if (__any_sync(kFull, is_nan(v))) return __int_as_float(0x7fc00000);
  return __uint_as_float(m);
}

// -- the register-resident path, nz <= 8 ----------------------------------

__host__ __device__ constexpr int ceil_pow2(int v) {
  return v <= 1 ? 1 : 2 * ceil_pow2((v + 1) / 2);
}
__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}
// Values a lane carries into warp_allreduce for V totals: a power of
// two up to 32, a multiple of 32 beyond (each stage halves it).
__host__ __device__ constexpr int red_width(int v) {
  return v <= 32 ? ceil_pow2(v) : 32 * ((v + 31) / 32);
}
// Packed lower triangle, row-major: (i, j), j <= i.
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// One stage of warp_allreduce (offset 16 >> ST), then the next.  The
// stage index is a template argument so that every index into w is a
// compile-time constant and w stays in registers.
template <int ST, typename T, int W>
__device__ __forceinline__ void reduce_stages(T (&w)[W], int lane) {
  if constexpr (ST < 5) {
    constexpr int o = 16 >> ST;
    constexpr int halvings = W >= 32 ? 5 : ilog2(W);
    if constexpr (ST < halvings) {
      constexpr int h = W >> (ST + 1);
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const T send = up ? w[i] : w[i + h];
        const T keep = up ? w[i + h] : w[i];
        w[i] = keep + __shfl_xor_sync(kFull, send, o);
      }
    } else {
      w[0] += __shfl_xor_sync(kFull, w[0], o);
    }
    reduce_stages<ST + 1>(w, lane);
  }
}

// Sum w[0..V) over the warp; every lane ends with the totals.  Each
// __shfl_xor_sync stage sends half of what a lane carries to its
// partner and keeps the sum of the other half (once a lane carries one
// value, the remaining stages are a plain butterfly); the totals then
// go through `buf` (W elements of shared memory) to every lane.  Each
// total is formed in one fixed order, so every lane reads the same
// bits, whatever the launch.  w[V..W) must be zero on entry.
template <typename T, int V, int W>
__device__ __forceinline__ void warp_allreduce(T (&w)[W], T* buf, int lane) {
  reduce_stages<0>(w, lane);
  constexpr int per = W >= 32 ? W / 32 : 1;
  constexpr int group = W >= 32 ? 1 : 32 / W;
  if ((lane & (group - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < per; ++i) buf[(lane / group) * per + i] = w[i];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < V; ++i) w[i] = buf[i];
  __syncwarp();
}

// In-place Cholesky of the packed lower triangle C (M + reg I) in the
// reference's clamped column form; inv[j] = 1/L_jj for the solves.
// Where the clamp is not active, L_jj = C_jj r with r = 1/sqrt(C_jj),
// so 1/L_jj is r (to an ulp); otherwise (C_jj <= 0, inf or NaN) it is
// the reciprocal of L_jj itself, which keeps the reference's inf/NaN.
template <typename T, int NZ>
__device__ __forceinline__ void chol(T (&C)[NZ * (NZ + 1) / 2],
                                     T (&inv)[NZ]) {
  const T inv_floor = T(1) / Leg<T>::floor();
#pragma unroll
  for (int j = 0; j < NZ; ++j) {
    const T r = pmin(rroot(pmax(C[tri(j, j)], T(0))), inv_floor);
#pragma unroll
    for (int i = j; i < NZ; ++i) C[tri(i, j)] *= r;
    inv[j] = r > T(0) && r < inv_floor ? r : recip(C[tri(j, j)]);
#pragma unroll
    for (int a = j + 1; a < NZ; ++a)
#pragma unroll
      for (int c = j + 1; c <= a; ++c)
        C[tri(a, c)] -= C[tri(a, j)] * C[tri(c, j)];
  }
}

// y <- L'^-1 L^-1 y, column-oriented as the reference (fwd_sub, bwd_sub).
template <typename T, int NZ>
__device__ __forceinline__ void cho_solve(const T (&L)[NZ * (NZ + 1) / 2],
                                          const T (&inv)[NZ], T (&y)[NZ]) {
#pragma unroll
  for (int j = 0; j < NZ; ++j) {
    const T d = y[j] * inv[j];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      if (i != j) y[i] = y[i] - d * (i > j ? L[tri(i, j)] : T(0));
    y[j] = d;
  }
#pragma unroll
  for (int j = NZ - 1; j >= 0; --j) {
    const T d = y[j] * inv[j];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      if (i != j) y[i] = y[i] - d * (i < j ? L[tri(j, i)] : T(0));
    y[j] = d;
  }
}

template <typename T, int NZ, int ROWS>
__global__ void __launch_bounds__(32)
ipm_leg_fixed(const T* __restrict__ Qg, const T* __restrict__ qg,
              const T* __restrict__ Ag, const T* __restrict__ bg,
              const T* __restrict__ zin, const T* __restrict__ s_in,
              const T* __restrict__ l_in, T* __restrict__ zout,
              T* __restrict__ sout, T* __restrict__ lout, int nc,
              int n_iter) {
  constexpr int TRI = NZ * (NZ + 1) / 2;
  constexpr int V1 = TRI + 2 * NZ + 1;  // A'DA, A'lam, A't, mu
  constexpr int W1 = red_width(V1);
  constexpr int W2 = red_width(NZ);     // A't of the corrector
  __shared__ T Qs[NZ * NZ + NZ];        // Q, then q (broadcast reads)
  __shared__ T buf[W1];
  const int lane = threadIdx.x;
  const long long k = blockIdx.x;

  for (int i = lane; i < NZ * NZ; i += 32) Qs[i] = Qg[k * NZ * NZ + i];
  if (lane < NZ) Qs[NZ * NZ + lane] = qg[k * NZ + lane];
  T z[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) z[c] = zin[k * NZ + c];
  T A[ROWS][NZ], b[ROWS], s[ROWS], lam[ROWS];
  bool ok[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = lane + 32 * r;
    ok[r] = row < nc;
    const long long o = k * nc + row;
#pragma unroll
    for (int c = 0; c < NZ; ++c) A[r][c] = ok[r] ? Ag[o * NZ + c] : T(0);
    b[r] = ok[r] ? bg[o] : T(0);
    s[r] = ok[r] ? s_in[o] : T(1);
    lam[r] = ok[r] ? l_in[o] : T(1);
  }
  __syncwarp();

  const T reg = Leg<T>::reg(), tiny = Leg<T>::tiny(), inf = Leg<T>::inf();
  const T nc_t = T(nc), inv_nc = recip(nc_t);
  for (int it = 0; it < n_iter; ++it) {
    // Residuals, scalings and every partial sum of the iteration start.
    T is[ROWS], il[ROWS], D[ROWS], rp[ROWS];
    T w[W1];
#pragma unroll
    for (int i = 0; i < W1; ++i) w[i] = T(0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      s[r] = pmax(s[r], tiny);
      lam[r] = pmax(lam[r], tiny);
      is[r] = recip(s[r]);
      il[r] = recip(lam[r]);
      D[r] = lam[r] * is[r];
      T az = 0;
#pragma unroll
      for (int c = 0; c < NZ; ++c) az += A[r][c] * z[c];
      rp[r] = az + s[r] - b[r];
      if (ok[r]) {
        const T sl = s[r] * lam[r];
        const T t = D[r] * rp[r] - sl * is[r];  // r_c = s lam (predictor)
        T DA[NZ];
#pragma unroll
        for (int c = 0; c < NZ; ++c) DA[c] = D[r] * A[r][c];
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
          for (int c = 0; c <= i; ++c) w[tri(i, c)] += A[r][i] * DA[c];
#pragma unroll
        for (int c = 0; c < NZ; ++c) {
          w[TRI + c] += A[r][c] * lam[r];
          w[TRI + NZ + c] += A[r][c] * t;
        }
        w[TRI + 2 * NZ] += sl;
      }
    }
    warp_allreduce<T, V1>(w, buf, lane);
    const T mu = w[TRI + 2 * NZ] / nc_t;
    const T inv_mu = recip(pmax(mu, Leg<T>::mu_floor()));
    // r_d = Q z + q + A'lam;  C = Q + A'DA + reg I;  its factor.
    T rd[NZ], L[TRI], inv[NZ], dz[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      T acc = 0;
#pragma unroll
      for (int c = 0; c < NZ; ++c) acc += Qs[i * NZ + c] * z[c];
      rd[i] = acc + Qs[NZ * NZ + i] + w[TRI + i];
#pragma unroll
      for (int c = 0; c <= i; ++c) {
        const T v = Qs[i * NZ + c] + w[tri(i, c)];
        L[tri(i, c)] = c == i ? v + reg : v;
      }
    }
    chol<T, NZ>(L, inv);
    // Predictor (affine scaling): rhs = -r_d - A'(D r_p - r_c/s).
#pragma unroll
    for (int i = 0; i < NZ; ++i) dz[i] = -rd[i] - w[TRI + NZ + i];
    cho_solve<T, NZ>(L, inv, dz);
    T dsa[ROWS], dla[ROWS];
    T mp = inf, md = inf;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      T adz = 0;
#pragma unroll
      for (int c = 0; c < NZ; ++c) adz += A[r][c] * dz[c];
      const T rc = s[r] * lam[r];
      dla[r] = D[r] * (adz + rp[r]) - rc * is[r];
      dsa[r] = -(rc + s[r] * dla[r]) * il[r];
      if (ok[r]) {
        mp = pmin(mp, dsa[r] < T(0) ? -s[r] / dsa[r] : inf);
        md = pmin(md, dla[r] < T(0) ? -lam[r] / dla[r] : inf);
      }
    }
    mp = warp_min_nonneg(mp);
    md = warp_min_nonneg(md);
    T a_p = pmin(T(1), mp), a_d = pmin(T(1), md);
    T aff = 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (ok[r]) aff += (s[r] + a_p * dsa[r]) * (lam[r] + a_d * dla[r]);
    // sigma = (mu_aff / max(mu, floor))^3, mu_aff = sum / nc.
    const T ratio = warp_sum(aff) * (inv_nc * inv_mu);
    const T smu = ratio * ratio * ratio * mu;
    // Corrector with centering: r_c = s lam + ds_a dl_a - sigma mu.
    T rc[ROWS];
    T w2[W2];
#pragma unroll
    for (int i = 0; i < W2; ++i) w2[i] = T(0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      rc[r] = s[r] * lam[r] + dsa[r] * dla[r] - smu;
      if (ok[r]) {
        const T t = D[r] * rp[r] - rc[r] * is[r];
#pragma unroll
        for (int c = 0; c < NZ; ++c) w2[c] += A[r][c] * t;
      }
    }
    warp_allreduce<T, NZ>(w2, buf, lane);
#pragma unroll
    for (int i = 0; i < NZ; ++i) dz[i] = -rd[i] - w2[i];
    cho_solve<T, NZ>(L, inv, dz);
    T ds[ROWS], dl[ROWS];
    mp = inf;
    md = inf;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      T adz = 0;
#pragma unroll
      for (int c = 0; c < NZ; ++c) adz += A[r][c] * dz[c];
      dl[r] = D[r] * (adz + rp[r]) - rc[r] * is[r];
      ds[r] = -(rc[r] + s[r] * dl[r]) * il[r];
      if (ok[r]) {
        mp = pmin(mp, ds[r] < T(0) ? -s[r] / ds[r] : inf);
        md = pmin(md, dl[r] < T(0) ? -lam[r] / dl[r] : inf);
      }
    }
    mp = warp_min_nonneg(mp);
    md = warp_min_nonneg(md);
    a_p = pmin(T(1), T(0.995) * mp);
    a_d = pmin(T(1), T(0.995) * md);
#pragma unroll
    for (int c = 0; c < NZ; ++c) z[c] = z[c] + a_p * dz[c];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      s[r] = s[r] + a_p * ds[r];
      lam[r] = lam[r] + a_d * dl[r];
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < NZ; ++c) zout[k * NZ + c] = z[c];
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (ok[r]) {
      const long long o = k * nc + lane + 32 * r;
      sout[o] = s[r];
      lout[o] = lam[r];
    }
  }
}

// -- the large path, nz > 32 or nc > 128 ----------------------------------

// Bytes of shared memory the large path uses for one QP (see the
// carve-up in ipm_leg_large): the packed triangle, six nz-vectors,
// eleven nc-vectors, two chunks of A (a row is nb tiles of kTile
// columns, each group followed by one pad: large_col), the corrector's
// A't partials, the reduction slots, and the tile table (2 bytes a
// tile).
__host__ __device__ inline long long large_tiles(int nz) {
  const long long nb = (nz + kTile - 1) / kTile;
  return nb * (nb + 1) / 2;
}
__host__ __device__ inline long long large_smem(int nz, int nc,
                                                int itemsize) {
  const long long ld = (nz + kTile - 1) / kTile * (kTile + 1);
  return itemsize * ((long long)nz * (nz + 1) / 2 + 6LL * nz + 11LL * nc +
                     2LL * kLargeRows * ld + kLargeThreads +
                     4 * kLargeWarps) +
         2 * large_tiles(nz);
}

// Where column c of A sits in a staged row: groups of kTile columns,
// each followed by a pad, so the groups a warp's tiles read start
// kTile + 1 elements apart and fall in distinct banks.
__device__ __forceinline__ int large_col(int c) { return c + c / kTile; }

// (i, j), j <= i, of packed lower-triangle index e (the inverse of tri).
__device__ __forceinline__ void untri(int e, int& i, int& j) {
  int r = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > e) --r;
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  i = r;
  j = e - r * (r + 1) / 2;
}

// One element from global to shared memory, asynchronously (cp.async);
// a commit closes the group, wait_all waits for this thread's groups.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of rows [c0, c0 + rows) of A into `dst` (row stride ld,
// columns at large_col; the pads are never written): a warp per row,
// lanes over the row's entries.
template <typename T>
__device__ __forceinline__ void large_stage(T* dst, const T* __restrict__ A,
                                            int c0, int rows, int nz,
                                            int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kLargeWarps) {
    const T* src = A + (long long)(c0 + r) * nz;
    for (int c = lane; c < nz; c += 32)
      cp_async(dst + r * ld + large_col(c), src + c);
  }
  cp_async_commit();
}

// A block sum in two halves around a barrier the caller has anyway:
// warp_partial leaves each warp's butterfly total in red[warp];
// warps_total adds the kLargeWarps totals in order.
template <typename T>
__device__ __forceinline__ void warp_partial(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
}
template <typename T>
__device__ __forceinline__ T warps_total(const T* red) {
  T v = red[0];
#pragma unroll
  for (int w = 1; w < kLargeWarps; ++w) v += red[w];
  return v;
}

// The primal and the dual step lengths min(1, tau min ratio) of the
// block, from each thread's running minima of the ratios: one warp
// reduction each, one exchange through red (2 kLargeWarps slots), one
// barrier.  NaN-propagating.
template <typename T>
__device__ __forceinline__ void large_ftb(T mp, T md, T tau, T* red, T& a_p,
                                          T& a_d) {
  mp = warp_min_nonneg(mp);
  md = warp_min_nonneg(md);
  if ((threadIdx.x & 31) == 0) {
    red[2 * (threadIdx.x >> 5)] = mp;
    red[2 * (threadIdx.x >> 5) + 1] = md;
  }
  __syncthreads();
  mp = red[0];
  md = red[1];
#pragma unroll
  for (int w = 1; w < kLargeWarps; ++w) {
    mp = pmin(mp, red[2 * w]);
    md = pmin(md, red[2 * w + 1]);
  }
  a_p = pmin(T(1), tau * mp);
  a_d = pmin(T(1), tau * md);
}

// Row blocks of 32 a lane of the factor's warp holds: nz <= 256.
constexpr int kRowBlocks = kLargeThreads / 32;

// Column j of the warp's left-looking factor, for N row blocks on and
// below the pivot (rows a = j + lane + 32 m, m < N; past nz a lane
// repeats row nz - 1 and stores nothing).  Each row's entry is C_aj less
// L_ak L_jk for k < j: the reference's rank-1 downdates of that entry,
// summed as P interleaved chains (k mod P, each in order) joined in a
// fixed order, so a lane keeps 4 independent FMA chains of loads only
// (N and P template arguments: no branch holds the loads back).  Then
// the pivot's reciprocal r from lane 0's diagonal (inv[j] as chol()
// above), the column scaled by r, a __syncwarp.
template <typename T, int N>
__device__ __forceinline__ void factor_column(int nz, int j, T* L, T* inv) {
  constexpr int P = N >= 4 ? 1 : 4 / N;
  const int lane = threadIdx.x & 31;
  const T inv_floor = T(1) / Leg<T>::floor();
  const int oj = tri(j, 0);
  int oa[N];
  T acc[N][P];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    oa[m] = tri(min(j + lane + 32 * m, nz - 1), 0);
    acc[m][0] = L[oa[m] + j];
#pragma unroll
    for (int h = 1; h < P; ++h) acc[m][h] = T(0);
  }
  int k = 0;
#pragma unroll 2
  for (; k + P <= j; k += P) {
#pragma unroll
    for (int h = 0; h < P; ++h) {
      const T ljk = L[oj + k + h];
#pragma unroll
      for (int m = 0; m < N; ++m) acc[m][h] -= L[oa[m] + k + h] * ljk;
    }
  }
  for (; k < j; ++k) {
    const T ljk = L[oj + k];
#pragma unroll
    for (int m = 0; m < N; ++m) acc[m][0] -= L[oa[m] + k] * ljk;
  }
#pragma unroll
  for (int m = 0; m < N; ++m)
#pragma unroll
    for (int h = 1; h < P; ++h) acc[m][0] += acc[m][h];
  const T cjj = __shfl_sync(kFull, acc[0][0], 0);
  const T r = pmin(rroot(pmax(cjj, T(0))), inv_floor);
  __syncwarp();  // every lane has read row j before it is scaled
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int a = j + lane + 32 * m;
    if (a < nz) L[tri(a, j)] = acc[m][0] * r;
  }
  if (lane == 0) inv[j] = r > T(0) && r < inv_floor ? r : recip(cjj * r);
  __syncwarp();
}

// In-place Cholesky of the packed lower triangle L (C = M + reg I) on
// one warp, in the reference's clamped column form, column by column
// (factor_column).  Not inlined: the warp's chain gets the registers to
// itself (the kernel's state waits in local memory across the call,
// once, instead of spilling inside the chain).
template <typename T>
__device__ __noinline__ void large_factor(int nz, T* L, T* inv) {
  __builtin_assume(__isShared(L) && __isShared(inv));
  for (int j = 0; j < nz; ++j) {
    switch ((nz - j + 31) >> 5) {
#define EHM_COLUMN(N)                          \
  case N:                                      \
    factor_column<T, N>(nz, j, L, inv);        \
    break;
      EHM_COLUMN(1) EHM_COLUMN(2) EHM_COLUMN(3) EHM_COLUMN(4)
      EHM_COLUMN(5) EHM_COLUMN(6) EHM_COLUMN(7) EHM_COLUMN(8)
#undef EHM_COLUMN
    }
  }
}

// y <- L'^-1 L^-1 y on one warp for the packed factor L and the pivots'
// reciprocals inv, lane l holding y_i, i = l + 32 m, in y[m] (MB row
// blocks; rows past nz hold values nothing reads).  Column-oriented as
// the reference (fwd_sub, bwd_sub), with its explicit zero outside the
// triangle: a step loads its factor entries first, then is the pivot
// row's value broadcast from its lane, times inv, and one FMA a row,
// with no lane branching.
template <typename T, int MB>
__device__ __forceinline__ void solve_rows(int nz, const T* L, const T* inv,
                                           T (&y)[MB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int jm = 0; jm < MB; ++jm) {
    const int jn = min(32, nz - 32 * jm);
    for (int jl = 0; jl < jn; ++jl) {
      const int j = 32 * jm + jl;
      T lv[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int i = lane + 32 * m;
        lv[m] = L[i > j && i < nz ? tri(i, j) : 0];
      }
      const T d = __shfl_sync(kFull, y[jm], jl) * inv[j];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int i = lane + 32 * m;
        const T u = y[m] - d * (i > j ? lv[m] : T(0));
        y[m] = i == j ? d : u;
      }
    }
  }
#pragma unroll
  for (int jm = MB - 1; jm >= 0; --jm) {
    const int jn = min(32, nz - 32 * jm);
    for (int jl = jn - 1; jl >= 0; --jl) {
      const int j = 32 * jm + jl;
      const int oj = tri(j, 0);
      T lv[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int i = lane + 32 * m;
        lv[m] = L[oj + (i < j ? i : 0)];
      }
      const T d = __shfl_sync(kFull, y[jm], jl) * inv[j];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int i = lane + 32 * m;
        const T u = y[m] - d * (i < j ? lv[m] : T(0));
        y[m] = i == j ? d : u;
      }
    }
  }
}

// The factor's warp, one solve: the predictor's rhs -r_d - A't, with
// r_d = (Q z + q) + A'lam (left in rd), or (pred false) the corrector's
// -r_d less its G groups of A't partials in order; solve_rows; the step
// into dz.
template <typename T, int MB>
__device__ __forceinline__ void rhs_solve(int nz, const T* L, const T* inv,
                                          T* rd, const T* wl, const T* wt,
                                          const T* part, int G, bool pred,
                                          T* dz) {
  const int lane = threadIdx.x & 31;
  T y[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const int i = lane + 32 * m;
    y[m] = T(0);
    if (i < nz) {
      if (pred) {
        const T rdi = rd[i] + wl[i];
        rd[i] = rdi;
        y[m] = -rdi - wt[i];
      } else {
        T w = 0;
        for (int g = 0; g < G; ++g) w += part[g * nz + i];
        y[m] = -rd[i] - w;
      }
    }
  }
  solve_rows<T, MB>(nz, L, inv, y);
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const int i = lane + 32 * m;
    if (i < nz) dz[i] = y[m];
  }
}

// rhs_solve for the row blocks nz takes.  Not inlined, as large_factor.
template <typename T>
__device__ __noinline__ void large_solve(int nz, const T* L, const T* inv,
                                         T* rd, const T* wl, const T* wt,
                                         const T* part, int G, bool pred,
                                         T* dz) {
  __builtin_assume(__isShared(L) && __isShared(inv) && __isShared(rd) &&
                   __isShared(wl) && __isShared(wt) && __isShared(part) &&
                   __isShared(dz));
  switch ((nz + 31) >> 5) {
#define EHM_SOLVE(N)                                                   \
  case N:                                                              \
    rhs_solve<T, N>(nz, L, inv, rd, wl, wt, part, G, pred, dz);        \
    break;
    EHM_SOLVE(1) EHM_SOLVE(2) EHM_SOLVE(3) EHM_SOLVE(4)
    EHM_SOLVE(5) EHM_SOLVE(6) EHM_SOLVE(7) EHM_SOLVE(8)
#undef EHM_SOLVE
  }
}

// The step of one right-hand side r_c from dz (shared), four lanes a
// row joined by two shuffles, then the row's own arithmetic on the
// lane holding it:
//   dlam = D (A dz + r_p) - r_c (1/s),   ds = -(r_c + s dlam) (1/lam),
// with each thread's running minima of the step ratios -v (1/dv) over
// dv < 0 for large_ftb.  PRED: r_c = s lam (the predictor), else rc.
template <typename T, bool PRED>
__device__ __forceinline__ void large_steps(
    int nz, int nc, const T* __restrict__ A, const T* dz, const T* rp,
    const T* D, const T* s, const T* lam, const T* is, const T* il,
    const T* rc, T* ds, T* dl, T& mp, T& md) {
  constexpr int P = 4, ROWS = kLargeThreads / P;
  const int r = threadIdx.x / P, p = threadIdx.x % P;
  const T inf = Leg<T>::inf();
  mp = inf;
  md = inf;
#pragma unroll 2
  for (int i0 = 0; i0 < nc; i0 += ROWS) {
    const int i = i0 + r;
    T acc = 0;
    if (i < nc) {
      const T* Ai = A + (long long)i * nz;
      for (int c = p; c < nz; c += P) acc += Ai[c] * dz[c];
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    if (p == 0 && i < nc) {
      const T si = s[i], li = lam[i];
      const T rci = PRED ? si * li : rc[i];
      const T dli = D[i] * (acc + rp[i]) - rci * is[i];
      const T dsi = -(rci + si * dli) * il[i];
      dl[i] = dli;
      ds[i] = dsi;
      mp = pmin(mp, dsi < T(0) ? (-si) * recip(dsi) : inf);
      md = pmin(md, dli < T(0) ? (-li) * recip(dli) : inf);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLargeThreads, 2)
ipm_leg_large(const T* __restrict__ Qg, const T* __restrict__ qg,
              const T* __restrict__ Ag, const T* __restrict__ bg,
              const T* __restrict__ zin, const T* __restrict__ s_in,
              const T* __restrict__ l_in, T* __restrict__ zout,
              T* __restrict__ sout, T* __restrict__ lout, int nz, int nc,
              int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = kLargeThreads, NW = kLargeWarps, R = kLargeRows;
  constexpr int RP = NT / R;  // lanes a row in the chunk's row pass
  static_assert(RP == 8, "the row pass joins 8 lanes a row");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long k = blockIdx.x;
  const T* __restrict__ Q = Qg + k * nz * nz;
  const T* __restrict__ q = qg + k * nz;
  const T* __restrict__ A = Ag + k * nc * nz;
  const int ntri = nz * (nz + 1) / 2;
  const int ld = (nz + kTile - 1) / kTile * (kTile + 1);
  const int ntiles = (int)large_tiles(nz);
  const int nchunks = (nc + R - 1) / R;

  // L: the packed lower triangle of A'DA, then C = Q + A'DA + reg I,
  // then its factor.  rd: Q z + q, then r_d.  ds/dl hold the
  // predictor's steps until the corrector's replace them.
  T* L = reinterpret_cast<T*>(smem_raw);
  T* wl = L + ntri;      // A'lam
  T* wt = wl + nz;       // A't (the predictor's)
  T* z = wt + nz;
  T* rd = z + nz;
  T* dz = rd + nz;
  T* inv = dz + nz;      // 1/L_jj
  T* b = inv + nz;
  T* s = b + nc;
  T* lam = s + nc;
  T* is = lam + nc;      // 1/s
  T* il = is + nc;       // 1/lam
  T* D = il + nc;
  T* rp = D + nc;
  T* rc = rp + nc;
  T* t = rc + nc;        // D r_p - r_c (1/s)
  T* ds = t + nc;
  T* dl = ds + nc;
  T* As = dl + nc;       // two chunks of R rows of A (large_col)
  T* part = As + 2 * R * ld;  // NT: the corrector's A't by row groups
  T* red = part + NT;    // 4 NW: mu, mu_aff, the step minima
  unsigned short* tiles = reinterpret_cast<unsigned short*>(red + 4 * NW);

  for (int i = tid; i < nz; i += NT) z[i] = zin[k * nz + i];
  for (int i = tid; i < nc; i += NT) {
    b[i] = bg[k * nc + i];
    s[i] = s_in[k * nc + i];
    lam[i] = l_in[k * nc + i];
  }
  // The chunks' padding columns stay zero; each thread's tiles (bi, bj)
  // of the lower triangle, indexed once.
  for (int e = tid; e < 2 * R * ld; e += NT) As[e] = T(0);
  for (int e = tid; e < ntiles; e += NT) {
    int bi, bj;
    untri(e, bi, bj);
    tiles[e] = (unsigned short)((bi << 8) | bj);
  }
  __syncthreads();

  const T reg = Leg<T>::reg(), tiny = Leg<T>::tiny();
  const T nc_t = T(nc), inv_nc = recip(nc_t);
  for (int it = 0; it < n_iter; ++it) {
    large_stage(As, A, 0, min(R, nc), nz, ld);
    // The thread's own rows i = tid + NT m: floors, reciprocals, D, mu.
    T mu_part = 0;
    for (int i = tid; i < nc; i += NT) {
      const T si = pmax(s[i], tiny), li = pmax(lam[i], tiny);
      const T isi = recip(si);
      s[i] = si;
      lam[i] = li;
      is[i] = isi;
      il[i] = recip(li);
      D[i] = li * isi;
      mu_part += si * li;
    }
    warp_partial(mu_part, red);
    // One pass over A in chunks: r_p = A z + s - b and the predictor's
    // t = D r_p - s lam (1/s) for the chunk's rows, then A'DA, A'lam
    // and A't summed over them.
    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = ch * R, rows = min(R, nc - c0);
      const T* cur = As + (ch & 1) * R * ld;
      cp_async_wait_all();
      __syncthreads();
      if (ch + 1 < nchunks)
        large_stage(As + ((ch + 1) & 1) * R * ld, A, c0 + R,
                    min(R, nc - c0 - R), nz, ld);
      {
        const int r = tid / RP, p = tid % RP;
        T acc = 0;
        if (r < rows)
          for (int c = p; c < nz; c += RP)
            acc += cur[r * ld + large_col(c)] * z[c];
        acc += __shfl_xor_sync(kFull, acc, 1);
        acc += __shfl_xor_sync(kFull, acc, 2);
        acc += __shfl_xor_sync(kFull, acc, 4);
        if (p == 0 && r < rows) {
          const int i = c0 + r;
          const T rpi = acc + s[i] - b[i];
          rp[i] = rpi;
          t[i] = D[i] * rpi - (s[i] * lam[i]) * is[i];
        }
      }
      __syncthreads();
      const bool first = ch == 0, last = ch == nchunks - 1;
      const T* Dc = D + c0;
      for (int e = tid; e < ntiles + nz; e += NT) {
        if (e < ntiles) {
          const int bi = tiles[e] >> 8, bj = tiles[e] & 255;
          const int i0 = bi * kTile, j0 = bj * kTile;
          const int pi = bi * (kTile + 1), pj = bj * (kTile + 1);
          T acc[kTile][kTile];
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c) {
              const int i = i0 + a, j = j0 + c;
              acc[a][c] = !first && i < nz && j <= i ? L[tri(i, j)] : T(0);
            }
          const T* Ar = cur;
          for (int r = 0; r < rows; ++r, Ar += ld) {
            const T dr = Dc[r];
            T ai[kTile], dj[kTile];
#pragma unroll
            for (int a = 0; a < kTile; ++a) ai[a] = Ar[pi + a];
#pragma unroll
            for (int c = 0; c < kTile; ++c) dj[c] = dr * Ar[pj + c];
#pragma unroll
            for (int a = 0; a < kTile; ++a)
#pragma unroll
              for (int c = 0; c < kTile; ++c) acc[a][c] += ai[a] * dj[c];
          }
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c) {
              const int i = i0 + a, j = j0 + c;
              if (i < nz && j <= i) {
                T v = acc[a][c];
                if (last) {
                  v = Q[(long long)i * nz + j] + v;
                  if (i == j) v = v + reg;
                }
                L[tri(i, j)] = v;
              }
            }
        } else {
          const int c = e - ntiles;
          T al = first ? T(0) : wl[c], at = first ? T(0) : wt[c];
          for (int r = 0; r < rows; ++r) {
            const T v = cur[r * ld + large_col(c)];
            al += v * lam[c0 + r];
            at += v * t[c0 + r];
          }
          wl[c] = al;
          wt[c] = at;
        }
      }
    }
    __syncthreads();
    // The factor on one warp while the others form Q z + q; then r_d =
    // Q z + q + A'lam and the predictor (affine scaling): rhs = -r_d -
    // A'(D r_p - r_c/s), on the factor's warp.
    if (warp == 0) {
      large_factor(nz, L, inv);
    } else {
      for (int i = tid - 32; i < nz; i += NT - 32) {
        const T* Qi = Q + (long long)i * nz;
        T acc = 0;
#pragma unroll 8
        for (int j = 0; j < nz; ++j) acc += Qi[j] * z[j];
        rd[i] = acc + q[i];
      }
    }
    __syncthreads();
    if (warp == 0) large_solve(nz, L, inv, rd, wl, wt, part, 0, true, dz);
    __syncthreads();
    const T mu = warps_total(red) / nc_t;
    const T inv_mu = recip(pmax(mu, Leg<T>::mu_floor()));
    T mp, md, a_p, a_d;
    large_steps<T, true>(nz, nc, A, dz, rp, D, s, lam, is, il, rc, ds, dl,
                         mp, md);
    large_ftb(mp, md, T(1), red + 2 * NW, a_p, a_d);
    // sigma = (mu_aff / max(mu, floor))^3, mu_aff = sum / nc.
    T aff = 0;
    for (int i = tid; i < nc; i += NT)
      aff += (s[i] + a_p * ds[i]) * (lam[i] + a_d * dl[i]);
    warp_partial(aff, red + NW);
    __syncthreads();
    const T ratio = warps_total(red + NW) * (inv_nc * inv_mu);
    const T smu = ratio * ratio * ratio * mu;
    // Corrector with centering: r_c = s lam + ds_a dl_a - sigma mu;
    // A't summed by G = NT / nz groups of rows, then the groups in order.
    for (int i = tid; i < nc; i += NT) {
      const T rci = s[i] * lam[i] + ds[i] * dl[i] - smu;
      rc[i] = rci;
      t[i] = D[i] * rp[i] - rci * is[i];
    }
    __syncthreads();
    const int G = NT / nz;
    if (tid < G * nz) {
      const int g = tid / nz, c = tid - g * nz;
      T acc = 0;
#pragma unroll 4
      for (int i = g; i < nc; i += G) acc += A[(long long)i * nz + c] * t[i];
      part[tid] = acc;
    }
    __syncthreads();
    if (warp == 0) large_solve(nz, L, inv, rd, wl, wt, part, G, false, dz);
    __syncthreads();
    large_steps<T, false>(nz, nc, A, dz, rp, D, s, lam, is, il, rc, ds, dl,
                          mp, md);
    large_ftb(mp, md, T(0.995), red + 2 * NW, a_p, a_d);
    for (int i = tid; i < nz; i += NT) z[i] = z[i] + a_p * dz[i];
    for (int i = tid; i < nc; i += NT) {
      s[i] = s[i] + a_p * ds[i];
      lam[i] = lam[i] + a_d * dl[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < nz; i += NT) zout[k * nz + i] = z[i];
  for (int i = tid; i < nc; i += NT) {
    sout[k * nc + i] = s[i];
    lout[k * nc + i] = lam[i];
  }
}

// -- the general path, 8 < nz <= 32 and nc <= 128 ------------------------

// The general path's nz buckets: a QP of nz variables runs the smallest
// bucket NZB >= nz, its loops unrolled to NZB; the columns from LO (one
// past the bucket below) are guarded by nz.  T is the edge of the f32
// leg's A'DA register tiles: NB blocks of T columns cover NZB, and the
// NB (NB + 1) / 2 tiles of the lower triangle fit one warp (21, 21 and
// 28 tiles); the f64 leg sums A'DA on the FP64 tensor cores instead.
template <int NZB> struct MidShape;
template <> struct MidShape<16> {
  static constexpr int T = 3, LO = 9;
};
template <> struct MidShape<24> {
  static constexpr int T = 4, LO = 17;
};
template <> struct MidShape<32> {
  static constexpr int T = 5, LO = 25;
};

template <int NZB> struct Mid {
  static constexpr int T = MidShape<NZB>::T;
  // Columns below LO are live for every nz of the bucket (nz >= LO).
  static constexpr int LO = MidShape<NZB>::LO;
  static constexpr int NB = (NZB + T - 1) / T;
  static constexpr int TILES = NB * (NB + 1) / 2;
  static_assert(TILES <= 32, "one A'DA tile a lane");
  // A staged: row r at r LDA + ((r >> 2) & 3), LDA = 4 (mod 16) and at
  // least NZB + 3.  A DMMA fragment (rows 4q..4q+3, 8 columns) and the
  // lanes' own rows (32 consecutive rows, one column) then each fall in
  // distinct banks (doubles: 16 lanes a wavefront).  Q and C rows LDC.
  static constexpr int LDA = (NZB + 14) / 16 * 16 + 4;
  static constexpr int LDC = NZB | 1;
  __host__ __device__ static constexpr int row(int r) {
    return r * LDA + ((r >> 2) & 3);
  }
};

// Rows of A (and of the D, lam and t vectors) a QP stages: nc in whole
// DMMA steps of 4, the rows past nc zero.
__host__ __device__ constexpr int mid_rows(int nc) { return (nc + 3) & ~3; }

// Elements of shared memory one QP of the general path uses: A staged,
// Q, C (then L), z, dz, A'lam and A't, and D, lam and t of every row.
template <int NZB>
__host__ __device__ constexpr long long mid_elems(int nc) {
  return (long long)mid_rows(nc) * Mid<NZB>::LDA +
         2LL * NZB * Mid<NZB>::LDC + 4LL * NZB + 3LL * mid_rows(nc);
}
__host__ __device__ inline long long mid_smem(int nz, int nc, int itemsize) {
  return itemsize * (nz <= 16   ? mid_elems<16>(nc)
                     : nz <= 24 ? mid_elems<24>(nc)
                                : mid_elems<32>(nc));
}

// d += a b for one m8n8k4 f64 tile on the FP64 tensor cores: lane l
// holds a = A(l / 4, l % 4), b = B(l % 4, l / 4) and d = D(l / 4,
// 2 (l % 4) + i).
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The assembly's pass over the rows, f64: A'DA's lower triangle in 8x8
// blocks, each A_ri (D_r A_rj) summed four rows a step on the tensor
// cores (A' is the A operand, D A the B operand, both from one load a
// block: lane l reads row 4q + l % 4, column 8 bm + l / 4), and A'lam,
// A't as one more block column whose B operand is (lam, t, 0, ...).
// Each output entry is its own sum over the rows in a fixed order; the
// rows past nc are zero.  C's entries on and below the diagonal go to
// Cs (row-major), A'lam and A't to wl and wt.
template <int NZB>
__device__ __forceinline__ void mid_assemble(const double* As,
                                             const double* Ds,
                                             const double* ls,
                                             const double* ts, int nc,
                                             int nz, double* Cs, double* wl,
                                             double* wt) {
  using S = Mid<NZB>;
  constexpr int B8 = NZB / 8, NBLK = B8 * (B8 + 1) / 2;
  const int lane = threadIdx.x, kk = lane & 3, g = lane >> 2;
  double acc[NBLK][2], ext[B8][2];
#pragma unroll
  for (int t = 0; t < NBLK; ++t) acc[t][0] = acc[t][1] = 0.0;
#pragma unroll
  for (int t = 0; t < B8; ++t) ext[t][0] = ext[t][1] = 0.0;
#pragma unroll 4
  for (int k0 = 0; k0 < nc; k0 += 4) {
    const int r = k0 + kk;
    const double* Ar = As + S::row(r);
    const double dr = Ds[r], lr = ls[r], tr = ts[r];
    const double e = g == 0 ? lr : g == 1 ? tr : 0.0;
    double a[B8], b[B8];
#pragma unroll
    for (int bm = 0; bm < B8; ++bm) {
      a[bm] = Ar[8 * bm + g];
      b[bm] = dr * a[bm];
    }
    int t = 0;
#pragma unroll
    for (int bm = 0; bm < B8; ++bm) {
#pragma unroll
      for (int bn = 0; bn <= bm; ++bn) dmma(acc[t++], a[bm], b[bn]);
      dmma(ext[bm], a[bm], e);
    }
  }
  int t = 0;
#pragma unroll
  for (int bm = 0; bm < B8; ++bm) {
    const int i = 8 * bm + g;
#pragma unroll
    for (int bn = 0; bn <= bm; ++bn, ++t)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 8 * bn + 2 * kk + q;
        if (i < nz && j <= i) Cs[i * S::LDC + j] = acc[t][q];
      }
    if (kk == 0 && i < nz) {
      wl[i] = ext[bm][0];
      wt[i] = ext[bm][1];
    }
  }
}

// The same pass, f32 (no FP32 tensor-core product in IEEE f32): lane e
// < TILES sums its TxT tile (bi, bj) of A'DA's lower triangle, A_ri
// (D_r A_rj), over the rows in order; each live lane A'lam and A't for
// its variable.
template <int NZB>
__device__ __forceinline__ void mid_assemble(const float* As,
                                             const float* Ds,
                                             const float* ls,
                                             const float* ts, int nc,
                                             int nz, float* Cs, float* wl,
                                             float* wt) {
  using S = Mid<NZB>;
  constexpr int TT = S::T;
  const int lane = threadIdx.x;
  const int me = lane < nz ? lane : nz - 1;
  int bi, bj;
  untri(lane < S::TILES ? lane : 0, bi, bj);
  float acc[TT][TT];
#pragma unroll
  for (int a = 0; a < TT; ++a)
#pragma unroll
    for (int c = 0; c < TT; ++c) acc[a][c] = 0.f;
  float al = 0.f, at = 0.f;
#pragma unroll 2
  for (int r = 0; r < nc; ++r) {
    const float* Ar = As + S::row(r);
    const float dr = Ds[r];
    float x[TT], y[TT];
#pragma unroll
    for (int a = 0; a < TT; ++a) x[a] = Ar[bi * TT + a];
#pragma unroll
    for (int c = 0; c < TT; ++c) y[c] = dr * Ar[bj * TT + c];
#pragma unroll
    for (int a = 0; a < TT; ++a)
#pragma unroll
      for (int c = 0; c < TT; ++c) acc[a][c] += x[a] * y[c];
    const float v = Ar[me];
    al += v * ls[r];
    at += v * ts[r];
  }
  if (lane < S::TILES) {
#pragma unroll
    for (int a = 0; a < TT; ++a)
#pragma unroll
      for (int c = 0; c < TT; ++c) {
        const int i = bi * TT + a, j = bj * TT + c;
        if (i < nz && j <= i) Cs[i * S::LDC + j] = acc[a][c];
      }
  }
  if (lane < nz) {
    wl[lane] = al;
    wt[lane] = at;
  }
}

// A_r . v over the nz live columns of the staged row Ar (v in shared
// memory, read by broadcast).  Unrolled to the bucket: every load is
// made, and a column the bucket may lack (c >= LO) is skipped by a
// select when c >= nz, so that no branch holds a load back and its
// product never reaches the sum.
template <typename T, int NZB>
__device__ __forceinline__ T mid_dot(const T* Ar, const T* v, int nz) {
  T acc = 0;
#pragma unroll
  for (int c = 0; c < NZB; ++c) {
    const T f = fma(Ar[c], v[c], acc);
    acc = c < Mid<NZB>::LO || c < nz ? f : acc;
  }
  return acc;
}

// y <- L'^-1 L^-1 y on the QP's warp, lane i holding y_i: forward with
// row i of L in registers (L; its steps past nz skipped, a uniform
// branch a step), backward over the nz columns with column i of L from
// Lt (column-major, stride LDC; lanes past nz read the last column and
// hold values nothing reads).  Column-oriented as the reference
// (fwd_sub, bwd_sub), with its explicit zero outside the triangle: a
// step is the pivot row's value times 1/L_jj (inv, the pivot lane's),
// broadcast by __shfl_sync, and one FMA a lane, with no division and no
// lane branching.
template <typename T, int NZB>
__device__ __forceinline__ T mid_solve(int nz, int me, const T (&L)[NZB],
                                       T inv, const T* Lt, T y) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NZB; ++j) {
    if (j < nz) {
      const T d = __shfl_sync(kFull, y * inv, j);
      const T u = y - d * (lane > j ? L[j] : T(0));
      y = lane == j ? d : u;
    }
  }
  const T* Lc = Lt + me * Mid<NZB>::LDC;
#pragma unroll 4
  for (int j = nz - 1; j >= 0; --j) {
    const T lji = Lc[j];
    const T d = __shfl_sync(kFull, y * inv, j);
    const T u = y - d * (lane < j ? lji : T(0));
    y = lane == j ? d : u;
  }
  return y;
}

// One warp a QP and a block.  Lane i owns variable i (z_i, r_d_i, row i
// of C and L) and constraint rows i, i + 32, ... (s, lam, b and the
// steps in registers); A, Q, and C or L stay in shared memory.
template <typename T, int NZB>
__global__ void __launch_bounds__(32)
ipm_leg_mid(const T* __restrict__ Qg, const T* __restrict__ qg,
            const T* __restrict__ Ag, const T* __restrict__ bg,
            const T* __restrict__ zin, const T* __restrict__ s_in,
            const T* __restrict__ l_in, T* __restrict__ zout,
            T* __restrict__ sout, T* __restrict__ lout, int nz, int nc,
            int n_iter) {
  using S = Mid<NZB>;
  constexpr int LDC = S::LDC;
  constexpr int RMAX = kMaxNc / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ncp = mid_rows(nc);
  T* As = reinterpret_cast<T*>(smem_raw);  // ncp staged rows (S::row)
  T* Qs = As + ncp * S::LDA;               // Q, row-major
  T* Cs = Qs + NZB * LDC;                  // C row-major, then L by column
  T* zs = Cs + NZB * LDC;
  T* dzs = zs + NZB;
  T* wl = dzs + NZB;                       // A'lam, A't
  T* wt = wl + NZB;
  T* Ds = wt + NZB;                        // D, lam and t of every row
  T* ls = Ds + ncp;
  T* ts = ls + ncp;
  const int lane = threadIdx.x;
  const long long k = blockIdx.x;
  const int rows = (nc + 31) >> 5;
  const bool live = lane < nz;
  const int me = live ? lane : nz - 1;  // lanes past nz repeat the last

  // The QP's shared memory zeroed (the pads stay zero: no value past nz
  // is uninitialized), then A and Q by cp.async, once for all n_iter
  // iterations.
  for (long long e = lane; e < mid_elems<NZB>(nc); e += 32) As[e] = T(0);
  __syncwarp();
  if (live) {
    const T* Ak = Ag + k * nc * nz + lane;
    for (int r = 0; r < nc; ++r)
      cp_async(As + S::row(r) + lane, Ak + (long long)r * nz);
    const T* Qk = Qg + k * nz * nz + lane;
    for (int i = 0; i < nz; ++i)
      cp_async(Qs + i * LDC + lane, Qk + (long long)i * nz);
  }
  cp_async_commit();
  T z = live ? zin[k * nz + lane] : T(0);
  const T qi = live ? qg[k * nz + lane] : T(0);
  if (live) zs[lane] = z;
  T b[RMAX], s[RMAX], lam[RMAX];
  bool ok[RMAX];
#pragma unroll
  for (int m = 0; m < RMAX; ++m) {
    const int row = lane + 32 * m;
    ok[m] = row < nc;
    const long long o = k * nc + row;
    b[m] = ok[m] ? bg[o] : T(0);
    s[m] = ok[m] ? s_in[o] : T(1);
    lam[m] = ok[m] ? l_in[o] : T(1);
  }
  cp_async_wait_all();
  __syncwarp();

  const T reg = Leg<T>::reg(), tiny = Leg<T>::tiny(), inf = Leg<T>::inf();
  const T nc_t = T(nc), inv_nc = recip(nc_t);
  const T inv_floor = T(1) / Leg<T>::floor();
  for (int it = 0; it < n_iter; ++it) {
    // The lane's rows: floors, 1/s, 1/lam, D, r_p = A z + s - b, the
    // predictor's t = D r_p - s lam (1/s), mu's partial; D, lam and t to
    // shared memory for the assembly.  Q z + q for the lane's variable.
    T is[RMAX], il[RMAX], D[RMAX], rp[RMAX];
    T mu_part = 0;
#pragma unroll
    for (int m = 0; m < RMAX; ++m) {
      is[m] = il[m] = D[m] = rp[m] = T(0);
      if (m < rows) {
        const int row = lane + 32 * m;
        s[m] = pmax(s[m], tiny);
        lam[m] = pmax(lam[m], tiny);
        is[m] = recip(s[m]);
        il[m] = recip(lam[m]);
        D[m] = lam[m] * is[m];
        rp[m] = mid_dot<T, NZB>(As + S::row(min(row, nc - 1)), zs, nz) +
                s[m] - b[m];
        if (ok[m]) {
          const T sl = s[m] * lam[m];
          Ds[row] = D[m];
          ls[row] = lam[m];
          ts[row] = D[m] * rp[m] - sl * is[m];
          mu_part += sl;
        }
      }
    }
    T qz = 0;
#pragma unroll
    for (int c = 0; c < NZB; ++c) {
      const T f = fma(Qs[me * LDC + c], zs[c], qz);
      qz = c < S::LO || c < nz ? f : qz;
    }
    qz = qz + qi;
    const T mu = warp_sum(mu_part) / nc_t;
    const T inv_mu = recip(pmax(mu, Leg<T>::mu_floor()));
    __syncwarp();

    // One pass over the rows: A'DA's lower triangle into Cs, A'lam and
    // A't into wl and wt (mid_assemble).
    mid_assemble<NZB>(As, Ds, ls, ts, nc, nz, Cs, wl, wt);
    __syncwarp();
    // Row `me` of C = Q + A'DA + reg I on and below the diagonal, zero
    // above; r_d = Q z + q + A'lam.
    T L[NZB];
#pragma unroll
    for (int c = 0; c < NZB; ++c) {
      const T v = Qs[me * LDC + c] + Cs[me * LDC + c];
      L[c] = c < me ? v : c == me ? (c == lane ? v + reg : v) : T(0);
    }
    const T rd = qz + wl[me], at = wt[me];
    __syncwarp();  // C read before the factor's columns overwrite it

    // The factor, right-looking in the reference's clamped column form,
    // two columns a round: row j's diagonal and row j + 1's entries j
    // and j + 1 are broadcast once, and every lane forms both pivot
    // reciprocals r = min(rsqrt(max(C_jj, 0)), 1/floor) and L_{j+1,j}
    // itself; each lane scales its entries of the two columns, stores
    // them for the other rows, and applies both rank-1 downdates in the
    // reference's order (column j, then j + 1) after one __syncwarp.
    // The entries past nz are dead (nothing reads them); an odd nz's
    // last round uses its first column only.  Each lane keeps its own r
    // and L_ii (selects) and forms 1/L_ii after the factor: r where the
    // clamp is inactive, else the reciprocal of L_ii itself.
    T r_own = T(0), l_own = T(0);
#pragma unroll
    for (int j = 0; j < NZB; j += 2) {
      if (j < nz) {
        const T c00 = __shfl_sync(kFull, L[j], j);
        const T c10 = __shfl_sync(kFull, L[j], j + 1);
        const T c11 = __shfl_sync(kFull, L[j + 1], j + 1);
        const T r0 = pmin(rroot(pmax(c00, T(0))), inv_floor);
        const T l10 = c10 * r0;
        const T r1 = pmin(rroot(pmax(fma(-l10, l10, c11), T(0))), inv_floor);
        const T li0 = lane >= j ? L[j] * r0 : T(0);
        const T li1 = lane >= j + 1 ? fma(-li0, l10, L[j + 1]) * r1 : T(0);
        L[j] = li0;
        L[j + 1] = li1;
        r_own = lane == j ? r0 : lane == j + 1 ? r1 : r_own;
        l_own = lane == j ? li0 : lane == j + 1 ? li1 : l_own;
        if (live) {
          Cs[j * LDC + lane] = li0;
          Cs[(j + 1) * LDC + lane] = li1;
        }
        __syncwarp();
#pragma unroll
        for (int c = j + 2; c < NZB; ++c)
          L[c] = fma(-li1, Cs[(j + 1) * LDC + c],
                     fma(-li0, Cs[j * LDC + c], L[c]));
      }
    }
    const T inv = r_own > T(0) && r_own < inv_floor ? r_own : recip(l_own);

    // Predictor (affine scaling): rhs = -r_d - A'(D r_p - r_c/s).
    T dz = mid_solve<T, NZB>(nz, me, L, inv, Cs, -rd - at);
    if (live) dzs[lane] = dz;
    __syncwarp();
    T dsa[RMAX], dla[RMAX];
    T mp = inf, md = inf;
#pragma unroll
    for (int m = 0; m < RMAX; ++m) {
      dsa[m] = dla[m] = T(0);
      if (m < rows) {
        const int row = lane + 32 * m;
        const T adz = mid_dot<T, NZB>(As + S::row(min(row, nc - 1)), dzs,
                                      nz);
        const T rc = s[m] * lam[m];
        dla[m] = D[m] * (adz + rp[m]) - rc * is[m];
        dsa[m] = -(rc + s[m] * dla[m]) * il[m];
        if (ok[m]) {
          mp = pmin(mp, dsa[m] < T(0) ? (-s[m]) * recip(dsa[m]) : inf);
          md = pmin(md, dla[m] < T(0) ? (-lam[m]) * recip(dla[m]) : inf);
        }
      }
    }
    mp = warp_min_nonneg(mp);
    md = warp_min_nonneg(md);
    T a_p = pmin(T(1), mp), a_d = pmin(T(1), md);
    T aff = 0;
#pragma unroll
    for (int m = 0; m < RMAX; ++m)
      if (m < rows && ok[m])
        aff += (s[m] + a_p * dsa[m]) * (lam[m] + a_d * dla[m]);
    // sigma = (mu_aff / max(mu, floor))^3, mu_aff = sum / nc.
    const T ratio = warp_sum(aff) * (inv_nc * inv_mu);
    const T smu = ratio * ratio * ratio * mu;

    // Corrector with centering: r_c = s lam + ds_a dl_a - sigma mu; its
    // A't for the lane's variable as four interleaved chains over the
    // rows, joined in a fixed order.
    T rc[RMAX];
#pragma unroll
    for (int m = 0; m < RMAX; ++m) {
      rc[m] = s[m] * lam[m] + dsa[m] * dla[m] - smu;
      if (m < rows && ok[m])
        ts[lane + 32 * m] = D[m] * rp[m] - rc[m] * is[m];
    }
    __syncwarp();
    T p0 = 0, p1 = 0, p2 = 0, p3 = 0;
    for (int r = 0; r < nc; r += 4) {  // the rows past nc are zero
      p0 += As[S::row(r) + me] * ts[r];
      p1 += As[S::row(r + 1) + me] * ts[r + 1];
      p2 += As[S::row(r + 2) + me] * ts[r + 2];
      p3 += As[S::row(r + 3) + me] * ts[r + 3];
    }
    dz = mid_solve<T, NZB>(nz, me, L, inv, Cs, -rd - ((p0 + p1) + (p2 + p3)));
    if (live) dzs[lane] = dz;
    __syncwarp();
    T ds[RMAX], dl[RMAX];
    mp = inf;
    md = inf;
#pragma unroll
    for (int m = 0; m < RMAX; ++m) {
      ds[m] = dl[m] = T(0);
      if (m < rows) {
        const int row = lane + 32 * m;
        const T adz = mid_dot<T, NZB>(As + S::row(min(row, nc - 1)), dzs,
                                      nz);
        dl[m] = D[m] * (adz + rp[m]) - rc[m] * is[m];
        ds[m] = -(rc[m] + s[m] * dl[m]) * il[m];
        if (ok[m]) {
          mp = pmin(mp, ds[m] < T(0) ? (-s[m]) * recip(ds[m]) : inf);
          md = pmin(md, dl[m] < T(0) ? (-lam[m]) * recip(dl[m]) : inf);
        }
      }
    }
    mp = warp_min_nonneg(mp);
    md = warp_min_nonneg(md);
    a_p = pmin(T(1), T(0.995) * mp);
    a_d = pmin(T(1), T(0.995) * md);
    z = z + a_p * dz;
    if (live) zs[lane] = z;
#pragma unroll
    for (int m = 0; m < RMAX; ++m) {
      s[m] = s[m] + a_p * ds[m];
      lam[m] = lam[m] + a_d * dl[m];
    }
    __syncwarp();
  }

  if (live) zout[k * nz + lane] = z;
#pragma unroll
  for (int m = 0; m < RMAX; ++m) {
    if (ok[m]) {
      const long long o = k * nc + lane + 32 * m;
      sout[o] = s[m];
      lout[o] = lam[m];
    }
  }
}

// -- launch ----------------------------------------------------------------

template <typename T, int NZ>
int launch_fixed(const T* Q, const T* q, const T* A, const T* b, const T* z,
                 const T* s, const T* lam, T* zo, T* so, T* lo, int K, int nc,
                 int n_iter, cudaStream_t st) {
  const int rows = (nc + 31) / 32;
  if (rows <= 1)
    ipm_leg_fixed<T, NZ, 1><<<K, 32, 0, st>>>(Q, q, A, b, z, s, lam, zo, so,
                                              lo, nc, n_iter);
  else if (rows <= 2)
    ipm_leg_fixed<T, NZ, 2><<<K, 32, 0, st>>>(Q, q, A, b, z, s, lam, zo, so,
                                              lo, nc, n_iter);
  else
    ipm_leg_fixed<T, NZ, 4><<<K, 32, 0, st>>>(Q, q, A, b, z, s, lam, zo, so,
                                              lo, nc, n_iter);
  return (int)cudaGetLastError();
}

// The general path for 8 < nz <= 32, nc <= 128 (one warp a QP and a
// block), in the nz bucket NZB.
template <typename T, int NZB>
int launch_mid(const T* Q, const T* q, const T* A, const T* b, const T* z,
               const T* s, const T* lam, T* zo, T* so, T* lo, int K, int nz,
               int nc, int n_iter, cudaStream_t st) {
  const long long smem = mid_elems<NZB>(nc) * (long long)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      ipm_leg_mid<T, NZB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ipm_leg_mid<T, NZB><<<K, 32, (size_t)smem, st>>>(
      Q, q, A, b, z, s, lam, zo, so, lo, nz, nc, n_iter);
  return (int)cudaGetLastError();
}

// The large path for any shape within its ceiling (one block a QP).
template <typename T>
int launch_large(const T* Q, const T* q, const T* A, const T* b, const T* z,
                 const T* s, const T* lam, T* zo, T* so, T* lo, int K, int nz,
                 int nc, int n_iter, cudaStream_t st) {
  const long long smem = large_smem(nz, nc, (int)sizeof(T));
  if (nz > kLargeThreads || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ipm_leg_large<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ipm_leg_large<T><<<K, kLargeThreads, (size_t)smem, st>>>(
      Q, q, A, b, z, s, lam, zo, so, lo, nz, nc, n_iter);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* Q, const T* q, const T* A, const T* b, const T* z,
           const T* s, const T* lam, T* zo, T* so, T* lo, int K, int nz,
           int nc, int n_iter, void* stream) {
  if (K <= 0) return 0;
  if (nz < 1 || nc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nz > kMaxNz || nc > kMaxNc)
    return launch_large<T>(Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc,
                           n_iter, st);
  switch (nz) {
#define EHM_FIXED(N)                                                        \
  case N:                                                                   \
    return launch_fixed<T, N>(Q, q, A, b, z, s, lam, zo, so, lo, K, nc,     \
                              n_iter, st);
    EHM_FIXED(1) EHM_FIXED(2) EHM_FIXED(3) EHM_FIXED(4)
    EHM_FIXED(5) EHM_FIXED(6) EHM_FIXED(7) EHM_FIXED(8)
#undef EHM_FIXED
    default:
      break;
  }
  if (nz <= 16)
    return launch_mid<T, 16>(Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc,
                             n_iter, st);
  if (nz <= 24)
    return launch_mid<T, 24>(Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc,
                             n_iter, st);
  return launch_mid<T, 32>(Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc,
                           n_iter, st);
}

}  // namespace

extern "C" {

int ipm_leg_f64(const double* Q, const double* q, const double* A,
                const double* b, const double* z, const double* s,
                const double* lam, double* zo, double* so, double* lo, int K,
                int nz, int nc, int n_iter, void* stream) {
  return launch<double>(Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc, n_iter,
                        stream);
}

int ipm_leg_f32(const float* Q, const float* q, const float* A,
                const float* b, const float* z, const float* s,
                const float* lam, float* zo, float* so, float* lo, int K,
                int nz, int nc, int n_iter, void* stream) {
  return launch<float>(Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc, n_iter,
                       stream);
}

// The large path alone, whatever the shape's dispatch (within its
// ceiling): for timing it against the general path at the same shapes.
int ipm_leg_large_f64(const double* Q, const double* q, const double* A,
                      const double* b, const double* z, const double* s,
                      const double* lam, double* zo, double* so, double* lo,
                      int K, int nz, int nc, int n_iter, void* stream) {
  if (K <= 0) return 0;
  if (nz < 1 || nc < 1) return (int)cudaErrorInvalidValue;
  return launch_large<double>(Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc,
                              n_iter, (cudaStream_t)stream);
}

// The general path's limits (larger shapes take the large path), and
// the large path's: threads a block, rows a chunk, shared memory a
// block, and the bytes of shared memory it takes for one QP.
int ipm_leg_max_nz() { return kMaxNz; }
int ipm_leg_max_nc() { return kMaxNc; }
int ipm_leg_large_threads() { return kLargeThreads; }
int ipm_leg_large_rows() { return kLargeRows; }
long long ipm_leg_max_smem() { return kMaxSmem; }
long long ipm_leg_large_smem(int nz, int nc, int itemsize) {
  return large_smem(nz, nc, itemsize);
}
long long ipm_leg_general_smem(int nz, int nc, int itemsize) {
  return mid_smem(nz, nc, itemsize);
}

const char* ipm_leg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
