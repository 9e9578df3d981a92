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
// (ridge 1e-7 / 1e-10, slack floor 1e-8 / 1e-12) in float and double.
// The plain torch version is ipm_leg_torch in oracle/ipm_leg.py.
//
// Design.  One warp per QP.  A QP's operands (Q, A, b, q) and its
// working set (KKT matrix, factor, nc-sized step vectors) live in
// shared memory for the whole leg: device memory is read once (the
// operands and the start) and written once (z, s, lam) per launch, and
// all n_iter iterations run inside the launch.  The nc-wise work (r_p,
// D, the step vectors, the fraction-to-boundary minima, mu) is spread
// over the 32 lanes and reduced with shuffles; the KKT assembly
// computes the lower triangle, entries over lanes; the Cholesky and
// the two substitutions are column-serial with a lane per row (nz <=
// 32), separated by __syncwarp.  Every QP depends only on its own
// inputs -- no cross-QP reduction and no padding -- so a QP's result
// is independent of which batch it was launched in.
//
// What bounds it: neither bytes nor operations.  At the pendulum's
// shapes (nz 5-8, nc 35-39) a QP moves ~3 KB and does ~10^5 flops per
// leg; the leg is a chain of dependent warp-synchronous steps, so it
// is latency-bound.  Making it fast (several QPs per warp, registers
// instead of shared memory) is later work.
//
// NaN semantics follow the JAX reference: max/min propagate NaN (a
// diverging infeasible QP must stay non-finite so it classifies as
// not converged), and the substitutions multiply by an explicit zero
// outside the triangle exactly as the reference does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxNz = 32;
constexpr int kMaxNc = 128;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Leg;
template <> struct Leg<float> {
  static __device__ float reg() { return 1e-7f; }
  static __device__ float tiny() { return 1e-8f; }
  static __device__ float floor() { return 1e-30f; }
  static __device__ float mu_floor() { return 1e-12f; }
  static __device__ float inf() { return __int_as_float(0x7f800000); }
};
template <> struct Leg<double> {
  static __device__ double reg() { return 1e-10; }
  static __device__ double tiny() { return 1e-12; }
  static __device__ double floor() { return 1e-300; }
  static __device__ double mu_floor() { return 1e-12; }
  static __device__ double inf() {
    return __longlong_as_double(0x7ff0000000000000ll);
  }
};

__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return ::sqrt(a); }

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
__global__ void ipm_leg_kernel(const T* __restrict__ Qg,
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

template <typename T>
int launch(const T* Q, const T* q, const T* A, const T* b, const T* z,
           const T* s, const T* lam, T* zo, T* so, T* lo, int K, int nz,
           int nc, int n_iter, void* stream) {
  if (K <= 0) return 0;
  if (nz < 1 || nz > kMaxNz || nc < 1 || nc > kMaxNc)
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)warp_elems(nz, nc) * sizeof(T);
  // Up to 4 QPs (warps) per block, within the 227 KB a block may use.
  int warps = 4;
  while (warps > 1 && per_warp * warps > 200 * 1024) warps >>= 1;
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      ipm_leg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K + warps - 1) / warps;
  ipm_leg_kernel<T><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
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

int ipm_leg_max_nz() { return kMaxNz; }
int ipm_leg_max_nc() { return kMaxNc; }

const char* ipm_leg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
