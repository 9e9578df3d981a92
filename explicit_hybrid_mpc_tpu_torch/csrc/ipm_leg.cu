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
//  - nz 9..32 takes the general path (ipm_leg_general): the first
//    design, the QP's operands and factor in shared memory, lanes over
//    rows of the KKT matrix.  nz is not padded to 8 (0 * NaN would
//    leak NaN into live rows and change the sums).
//  - Every larger shape (nz > 32 or nc > 128; the quadrotor's QPs are
//    nz 60-65, nc 360-366) takes the large path (ipm_leg_large): one
//    block of 256 threads per QP.  There a QP does ~2 MFLOP an
//    iteration and A alone is 190 KB in f64, so the work is the
//    assembly of A'DA (nc nz (nz+1)/2 FMAs, ~80% of it) and the bound
//    is operations.  The packed factor and the nc-long vectors live in
//    shared memory; A streams from global memory (L2) in chunks of 16
//    rows, each chunk staged with D*A beside it, and every thread sums
//    its own entries of A'DA, A'lam and A't over the chunk; a warp per
//    row forms the row products A z and A dz.  The Cholesky is
//    right-looking in shared memory (two barriers a column), the
//    substitutions one barrier a column with thread i holding y_i.
//    Every sum runs in a fixed order (rows in order for each entry, a
//    fixed tree across threads), so a QP's result does not depend on
//    its batch.  Its ceiling is the shared memory of one block
//    (large_elems) and one thread per variable (nz <= 256).
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
constexpr int kLargeRows = 16;                // rows of A in a chunk
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

__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return ::sqrt(a); }
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
template <typename T> __device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) v = pmin(v, __shfl_xor_sync(kFull, v, o));
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

// -- the general path, 9 <= nz <= 32 --------------------------------------

// Elements of shared memory one QP uses (see the carve-up below).
__host__ __device__ inline int warp_elems(int nz, int nc) {
  return 3 * nz * nz + nc * nz + 4 * nz + 11 * nc;
}

// Solve the KKT system for one right-hand side r_c (in rc) and write
// the step (dz, ds, dl).  Mirrors kkt_step of the reference:
//   rhs  = -r_d - A'(D r_p - r_c/s)
//   dz   = L'^-1 L^-1 rhs
//   dlam = D (A dz + r_p) - r_c/s
//   ds   = -(r_c + s dlam)/lam
template <typename T>
__device__ void kkt_step(int lane, int nz, int nc, const T* A, const T* L,
                         const T* rd, const T* rp, const T* D, const T* s,
                         const T* lam, const T* rc, T* tmp, T* dz, T* ds,
                         T* dl) {
  for (int i = lane; i < nc; i += 32) tmp[i] = D[i] * rp[i] - rc[i] / s[i];
  __syncwarp();
  T y = 0;
  if (lane < nz) {
    T acc = 0;
    for (int i = 0; i < nc; ++i) acc += A[i * nz + lane] * tmp[i];
    y = -rd[lane] - acc;
  }
  // Forward substitution L y = rhs, lane j holds y_j.
  for (int j = 0; j < nz; ++j) {
    T yj = __shfl_sync(kFull, y, j);
    T d = yj / L[j * nz + j];
    if (lane < nz && lane != j) y = y - d * (lane > j ? L[lane * nz + j] : T(0));
    if (lane == j) y = d;
  }
  // Backward substitution L' x = y.
  for (int j = nz - 1; j >= 0; --j) {
    T xj = __shfl_sync(kFull, y, j);
    T d = xj / L[j * nz + j];
    if (lane < nz && lane != j) y = y - d * (lane < j ? L[j * nz + lane] : T(0));
    if (lane == j) y = d;
  }
  if (lane < nz) dz[lane] = y;
  __syncwarp();
  for (int i = lane; i < nc; i += 32) {
    T acc = 0;
    for (int k = 0; k < nz; ++k) acc += A[i * nz + k] * dz[k];
    T dli = D[i] * (acc + rp[i]) - rc[i] / s[i];
    dl[i] = dli;
    ds[i] = -(rc[i] + s[i] * dli) / lam[i];
  }
  __syncwarp();
}

// alpha = min(1, tau * min_{dv<0} -v/dv), NaN-propagating.
template <typename T>
__device__ T frac_to_boundary(int lane, int nc, const T* v, const T* dv,
                              T tau) {
  T m = Leg<T>::inf();
  for (int i = lane; i < nc; i += 32) {
    T r = dv[i] < T(0) ? -v[i] / dv[i] : Leg<T>::inf();
    m = pmin(m, r);
  }
  return pmin(T(1), tau * warp_min(m));
}

template <typename T>
__global__ void ipm_leg_general(const T* __restrict__ Qg,
                                const T* __restrict__ qg,
                                const T* __restrict__ Ag,
                                const T* __restrict__ bg,
                                const T* __restrict__ zin,
                                const T* __restrict__ s_in,
                                const T* __restrict__ l_in,
                                T* __restrict__ zout, T* __restrict__ sout,
                                T* __restrict__ lout, int K, int nz, int nc,
                                int n_iter, int warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * warps + warp;
  if (k >= K) return;  // whole warps exit; only __syncwarp is used below

  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * warp_elems(nz, nc);
  T* Q = base;
  T* C = Q + nz * nz;
  T* L = C + nz * nz;
  T* A = L + nz * nz;
  T* q = A + nc * nz;
  T* z = q + nz;
  T* rd = z + nz;
  T* dz = rd + nz;
  T* b = dz + nz;
  T* s = b + nc;
  T* lam = s + nc;
  T* rp = lam + nc;
  T* D = rp + nc;
  T* rc = D + nc;
  T* tmp = rc + nc;
  T* dsa = tmp + nc;
  T* dla = dsa + nc;
  T* ds = dla + nc;
  T* dl = ds + nc;

  const T reg = Leg<T>::reg(), tiny = Leg<T>::tiny();
  const T nc_t = T(nc);

  for (int i = lane; i < nz * nz; i += 32) Q[i] = Qg[k * nz * nz + i];
  for (int i = lane; i < nc * nz; i += 32) A[i] = Ag[k * nc * nz + i];
  for (int i = lane; i < nz; i += 32) {
    q[i] = qg[k * nz + i];
    z[i] = zin[k * nz + i];
  }
  for (int i = lane; i < nc; i += 32) {
    b[i] = bg[k * nc + i];
    s[i] = s_in[k * nc + i];
    lam[i] = l_in[k * nc + i];
  }
  __syncwarp();

  for (int it = 0; it < n_iter; ++it) {
    for (int i = lane; i < nc; i += 32) {
      s[i] = pmax(s[i], tiny);
      lam[i] = pmax(lam[i], tiny);
    }
    __syncwarp();
    // r_d = Q z + q + A' lam
    if (lane < nz) {
      T acc = 0, acc2 = 0;
      for (int c = 0; c < nz; ++c) acc += Q[lane * nz + c] * z[c];
      for (int i = 0; i < nc; ++i) acc2 += A[i * nz + lane] * lam[i];
      rd[lane] = acc + q[lane] + acc2;
    }
    // r_p = A z + s - b;  D = lam / s;  mu = s'lam / nc
    T mu_part = 0;
    for (int i = lane; i < nc; i += 32) {
      T acc = 0;
      for (int c = 0; c < nz; ++c) acc += A[i * nz + c] * z[c];
      rp[i] = acc + s[i] - b[i];
      D[i] = lam[i] / s[i];
      mu_part += s[i] * lam[i];
    }
    const T mu = warp_sum(mu_part) / nc_t;
    __syncwarp();
    // C = Q + A' D A + reg I, lower triangle.
    for (int e = lane; e < nz * nz; e += 32) {
      const int r = e / nz, c = e - r * nz;
      if (c <= r) {
        T acc = 0;
        for (int i = 0; i < nc; ++i)
          acc += A[i * nz + r] * (D[i] * A[i * nz + c]);
        T v = Q[r * nz + c] + acc;
        C[r * nz + c] = r == c ? v + reg : v;
      }
    }
    __syncwarp();
    // Cholesky, clamped column form: d = sqrt(max(C_jj, 0)),
    // L_ij = C_ij / max(d, floor) for i >= j, zero above the diagonal,
    // then the rank-1 downdate of the trailing lower triangle.
    for (int j = 0; j < nz; ++j) {
      const T d = root(pmax(C[j * nz + j], T(0)));
      const T dd = pmax(d, Leg<T>::floor());
      if (lane < nz) L[lane * nz + j] = lane >= j ? C[lane * nz + j] / dd : T(0);
      __syncwarp();
      for (int e = lane; e < nz * nz; e += 32) {
        const int r = e / nz, c = e - r * nz;
        if (c > j && c <= r) C[r * nz + c] -= L[r * nz + j] * L[c * nz + j];
      }
      __syncwarp();
    }
    // Predictor (affine scaling): r_c = s .* lam.
    for (int i = lane; i < nc; i += 32) rc[i] = s[i] * lam[i];
    __syncwarp();
    kkt_step(lane, nz, nc, A, L, rd, rp, D, s, lam, rc, tmp, dz, dsa, dla);
    T a_p = frac_to_boundary(lane, nc, s, dsa, T(1));
    T a_d = frac_to_boundary(lane, nc, lam, dla, T(1));
    T aff_part = 0;
    for (int i = lane; i < nc; i += 32)
      aff_part += (s[i] + a_p * dsa[i]) * (lam[i] + a_d * dla[i]);
    const T mu_aff = warp_sum(aff_part) / nc_t;
    const T ratio = mu_aff / pmax(mu, Leg<T>::mu_floor());
    const T sigma = ratio * ratio * ratio;
    // Corrector with centering.
    const T smu = sigma * mu;
    for (int i = lane; i < nc; i += 32)
      rc[i] = s[i] * lam[i] + dsa[i] * dla[i] - smu;
    __syncwarp();
    kkt_step(lane, nz, nc, A, L, rd, rp, D, s, lam, rc, tmp, dz, ds, dl);
    a_p = frac_to_boundary(lane, nc, s, ds, T(0.995));
    a_d = frac_to_boundary(lane, nc, lam, dl, T(0.995));
    if (lane < nz) z[lane] = z[lane] + a_p * dz[lane];
    for (int i = lane; i < nc; i += 32) {
      s[i] = s[i] + a_p * ds[i];
      lam[i] = lam[i] + a_d * dl[i];
    }
    __syncwarp();
  }

  for (int i = lane; i < nz; i += 32) zout[k * nz + i] = z[i];
  for (int i = lane; i < nc; i += 32) {
    sout[k * nc + i] = s[i];
    lout[k * nc + i] = lam[i];
  }
}

// -- the large path, nz > 32 or nc > 128 ----------------------------------

// Elements of shared memory the large path uses for one QP (see the
// carve-up in ipm_leg_large).
__host__ __device__ inline long long large_elems(int nz, int nc) {
  return (long long)nz * (nz + 1) / 2 + 5LL * nz +
         2LL * kLargeRows * nz + 11LL * nc + kLargeThreads + 2;
}

// (i, j), j <= i, of packed lower-triangle index e (the inverse of tri).
__device__ __forceinline__ void untri(int e, int& i, int& j) {
  int r = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > e) --r;
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  i = r;
  j = e - r * (r + 1) / 2;
}

// Sum (or NaN-propagating min) of one value per thread over the block,
// in a fixed tree order; every thread gets the result.  red holds
// kLargeThreads elements; the call begins and ends with a barrier.
template <typename T, bool MIN>
__device__ __forceinline__ T block_reduce(T v, T* red) {
  const int t = threadIdx.x;
  __syncthreads();
  red[t] = v;
  __syncthreads();
#pragma unroll
  for (int o = kLargeThreads / 2; o > 0; o >>= 1) {
    if (t < o) red[t] = MIN ? pmin(red[t], red[t + o]) : red[t] + red[t + o];
    __syncthreads();
  }
  const T r = red[0];
  __syncthreads();
  return r;
}

// y <- L'^-1 L^-1 y for the packed factor L; thread i < nz holds y_i in
// `y` and leaves x_i in out[i].  Column-oriented as the reference
// (fwd_sub, bwd_sub), including its explicit zero outside the
// triangle; the pivot's quotient goes through two alternating slots
// of `bc`, one barrier a column.
template <typename T>
__device__ void large_solve(int nz, const T* L, T y, T* bc, T* out) {
  const int i = threadIdx.x;
  int step = 0;
  for (int j = 0; j < nz; ++j, ++step) {
    if (i == j) bc[step & 1] = y / L[tri(j, j)];
    __syncthreads();
    const T d = bc[step & 1];
    if (i < nz) y = i == j ? d : y - d * (i > j ? L[tri(i, j)] : T(0));
  }
  for (int j = nz - 1; j >= 0; --j, ++step) {
    if (i == j) bc[step & 1] = y / L[tri(j, j)];
    __syncthreads();
    const T d = bc[step & 1];
    if (i < nz) y = i == j ? d : y - d * (i < j ? L[tri(j, i)] : T(0));
  }
  if (i < nz) out[i] = y;
  __syncthreads();
}

// The step of one right-hand side from dz (shared): a warp per row,
//   dlam = D (A dz + r_p) - r_c/s,   ds = -(r_c + s dlam)/lam.
template <typename T>
__device__ void large_steps(int nz, int nc, const T* __restrict__ A,
                            const T* dz, const T* rp, const T* D,
                            const T* s, const T* lam, const T* rc, T* ds,
                            T* dl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < nc; i += kLargeThreads / 32) {
    const T* Ai = A + (long long)i * nz;
    T acc = 0;
    for (int c = lane; c < nz; c += 32) acc += Ai[c] * dz[c];
    acc = warp_sum(acc);
    if (lane == 0) {
      const T dli = D[i] * (acc + rp[i]) - rc[i] / s[i];
      dl[i] = dli;
      ds[i] = -(rc[i] + s[i] * dli) / lam[i];
    }
  }
  __syncthreads();
}

// alpha = min(1, tau * min_{dv<0} -v/dv) over the block, NaN-propagating.
template <typename T>
__device__ T large_ftb(int nc, const T* v, const T* dv, T tau, T* red) {
  const T inf = Leg<T>::inf();
  T m = inf;
  for (int i = threadIdx.x; i < nc; i += kLargeThreads)
    m = pmin(m, dv[i] < T(0) ? -v[i] / dv[i] : inf);
  return pmin(T(1), tau * block_reduce<T, true>(m, red));
}

template <typename T>
__global__ void __launch_bounds__(kLargeThreads)
ipm_leg_large(const T* __restrict__ Qg, const T* __restrict__ qg,
              const T* __restrict__ Ag, const T* __restrict__ bg,
              const T* __restrict__ zin, const T* __restrict__ s_in,
              const T* __restrict__ l_in, T* __restrict__ zout,
              T* __restrict__ sout, T* __restrict__ lout, int nz, int nc,
              int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = kLargeThreads, NW = NT / 32, R = kLargeRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long k = blockIdx.x;
  const T* __restrict__ Q = Qg + k * nz * nz;
  const T* __restrict__ q = qg + k * nz;
  const T* __restrict__ A = Ag + k * nc * nz;
  const int ntri = nz * (nz + 1) / 2;

  // L: the packed lower triangle of A'DA, then of C = Q + A'DA + reg I,
  // then its factor; wl, wt: A'lam and A't (contiguous after L, so one
  // loop zeroes all three).
  T* L = reinterpret_cast<T*>(smem_raw);
  T* wl = L + ntri;
  T* wt = wl + nz;
  T* z = wt + nz;
  T* rd = z + nz;
  T* dz = rd + nz;
  T* As = dz + nz;       // R rows of A
  T* DAs = As + R * nz;  // the same rows times D
  T* b = DAs + R * nz;
  T* s = b + nc;
  T* lam = s + nc;
  T* rp = lam + nc;
  T* D = rp + nc;
  T* rc = D + nc;
  T* tmp = rc + nc;
  T* dsa = tmp + nc;
  T* dla = dsa + nc;
  T* ds = dla + nc;
  T* dl = ds + nc;
  T* red = dl + nc;      // NT: reductions, the factor's column, A't partials
  T* bc = red + NT;      // 2: the substitutions' broadcast slots

  const T reg = Leg<T>::reg(), tiny = Leg<T>::tiny();
  const T nc_t = T(nc);
  for (int i = tid; i < nz; i += NT) z[i] = zin[k * nz + i];
  for (int i = tid; i < nc; i += NT) {
    b[i] = bg[k * nc + i];
    s[i] = s_in[k * nc + i];
    lam[i] = l_in[k * nc + i];
  }

  for (int it = 0; it < n_iter; ++it) {
    __syncthreads();
    for (int i = tid; i < nc; i += NT) {
      s[i] = pmax(s[i], tiny);
      lam[i] = pmax(lam[i], tiny);
    }
    for (int e = tid; e < ntri + 2 * nz; e += NT) L[e] = T(0);
    __syncthreads();
    // One pass over A: r_p = A z + s - b, D = lam/s, the predictor's
    // r_c = s lam and t = D r_p - r_c/s, row by row; A'DA, A'lam and
    // A't summed chunk by chunk, each entry over the rows in order.
    for (int c0 = 0; c0 < nc; c0 += R) {
      const int rows = min(R, nc - c0);
      const T* Ac = A + (long long)c0 * nz;
      for (int e = tid; e < rows * nz; e += NT) As[e] = Ac[e];
      __syncthreads();
      for (int r = warp; r < rows; r += NW) {
        T acc = 0;
        for (int c = lane; c < nz; c += 32) acc += As[r * nz + c] * z[c];
        acc = warp_sum(acc);
        if (lane == 0) {
          const int i = c0 + r;
          const T rpi = acc + s[i] - b[i];
          const T Di = lam[i] / s[i];
          const T rci = s[i] * lam[i];
          rp[i] = rpi;
          D[i] = Di;
          rc[i] = rci;
          tmp[i] = Di * rpi - rci / s[i];
        }
      }
      __syncthreads();
      for (int e = tid; e < rows * nz; e += NT)
        DAs[e] = D[c0 + e / nz] * As[e];
      __syncthreads();
      for (int e = tid; e < ntri + 2 * nz; e += NT) {
        T acc = L[e];
        if (e < ntri) {
          int i, j;
          untri(e, i, j);
          for (int r = 0; r < rows; ++r) acc += As[r * nz + i] * DAs[r * nz + j];
        } else {
          const int c = e < ntri + nz ? e - ntri : e - ntri - nz;
          const T* v = (e < ntri + nz ? lam : tmp) + c0;
          for (int r = 0; r < rows; ++r) acc += As[r * nz + c] * v[r];
        }
        L[e] = acc;
      }
      __syncthreads();
    }
    T part = 0;
    for (int i = tid; i < nc; i += NT) part += s[i] * lam[i];
    const T mu = block_reduce<T, false>(part, red) / nc_t;
    // r_d = Q z + q + A'lam;  C = Q + A'DA + reg I.
    for (int i = tid; i < nz; i += NT) {
      T acc = 0;
      for (int c = 0; c < nz; ++c) acc += Q[i * nz + c] * z[c];
      rd[i] = acc + q[i] + wl[i];
    }
    for (int e = tid; e < ntri; e += NT) {
      int i, j;
      untri(e, i, j);
      const T v = Q[i * nz + j] + L[e];
      L[e] = i == j ? v + reg : v;
    }
    __syncthreads();
    // Cholesky in the clamped column form: d = sqrt(max(C_jj, 0)),
    // column j = C[:, j] / max(d, floor) (into red), then the rank-1
    // downdate of the trailing lower triangle.
    for (int j = 0; j < nz; ++j) {
      const T dd = pmax(root(pmax(L[tri(j, j)], T(0))), Leg<T>::floor());
      for (int i = j + tid; i < nz; i += NT) red[i] = L[tri(i, j)] / dd;
      __syncthreads();
      for (int i = j + tid; i < nz; i += NT) L[tri(i, j)] = red[i];
      const int m = nz - j - 1;
      for (int e = tid; e < m * (m + 1) / 2; e += NT) {
        int a, c;
        untri(e, a, c);
        a += j + 1;
        c += j + 1;
        L[tri(a, c)] -= red[a] * red[c];
      }
      __syncthreads();
    }
    // Predictor (affine scaling): rhs = -r_d - A'(D r_p - r_c/s).
    large_solve(nz, L, tid < nz ? -rd[tid] - wt[tid] : T(0), bc, dz);
    large_steps(nz, nc, A, dz, rp, D, s, lam, rc, dsa, dla);
    T a_p = large_ftb(nc, s, dsa, T(1), red);
    T a_d = large_ftb(nc, lam, dla, T(1), red);
    part = 0;
    for (int i = tid; i < nc; i += NT)
      part += (s[i] + a_p * dsa[i]) * (lam[i] + a_d * dla[i]);
    const T mu_aff = block_reduce<T, false>(part, red) / nc_t;
    const T ratio = mu_aff / pmax(mu, Leg<T>::mu_floor());
    const T smu = ratio * ratio * ratio * mu;
    // Corrector with centering: r_c = s lam + ds_a dl_a - sigma mu;
    // A't summed by G = NT / nz groups of rows, then the groups in order.
    for (int i = tid; i < nc; i += NT) {
      rc[i] = s[i] * lam[i] + dsa[i] * dla[i] - smu;
      tmp[i] = D[i] * rp[i] - rc[i] / s[i];
    }
    __syncthreads();
    const int G = NT / nz;
    if (tid < G * nz) {
      const int g = tid / nz, c = tid - g * nz;
      T acc = 0;
      for (int i = g; i < nc; i += G) acc += A[(long long)i * nz + c] * tmp[i];
      red[tid] = acc;
    }
    __syncthreads();
    T y = 0;
    if (tid < nz) {
      T w = 0;
      for (int g = 0; g < G; ++g) w += red[g * nz + tid];
      y = -rd[tid] - w;
    }
    large_solve(nz, L, y, bc, dz);
    large_steps(nz, nc, A, dz, rp, D, s, lam, rc, ds, dl);
    a_p = large_ftb(nc, s, ds, T(0.995), red);
    a_d = large_ftb(nc, lam, dl, T(0.995), red);
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

template <typename T>
int launch(const T* Q, const T* q, const T* A, const T* b, const T* z,
           const T* s, const T* lam, T* zo, T* so, T* lo, int K, int nz,
           int nc, int n_iter, void* stream) {
  if (K <= 0) return 0;
  if (nz < 1 || nc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nz > kMaxNz || nc > kMaxNc) {
    const long long smem = large_elems(nz, nc) * (long long)sizeof(T);
    if (nz > kLargeThreads || smem > kMaxSmem)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        ipm_leg_large<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    ipm_leg_large<T><<<K, kLargeThreads, (size_t)smem, st>>>(
        Q, q, A, b, z, s, lam, zo, so, lo, nz, nc, n_iter);
    return (int)cudaGetLastError();
  }
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
  const size_t per_warp = (size_t)warp_elems(nz, nc) * sizeof(T);
  // Up to 4 QPs (warps) per block, within the 227 KB a block may use.
  int warps = 4;
  while (warps > 1 && per_warp * warps > 200 * 1024) warps >>= 1;
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      ipm_leg_general<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K + warps - 1) / warps;
  ipm_leg_general<T><<<blocks, 32 * warps, smem, st>>>(
      Q, q, A, b, z, s, lam, zo, so, lo, K, nz, nc, n_iter, warps);
  return (int)cudaGetLastError();
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

// The general path's limits (larger shapes take the large path), and
// the large path's: threads a block, rows a chunk, shared memory a
// block, and the bytes of shared memory it takes for one QP.
int ipm_leg_max_nz() { return kMaxNz; }
int ipm_leg_max_nc() { return kMaxNc; }
int ipm_leg_large_threads() { return kLargeThreads; }
int ipm_leg_large_rows() { return kLargeRows; }
long long ipm_leg_max_smem() { return kMaxSmem; }
long long ipm_leg_large_smem(int nz, int nc, int itemsize) {
  return large_elems(nz, nc) * itemsize;
}

const char* ipm_leg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
