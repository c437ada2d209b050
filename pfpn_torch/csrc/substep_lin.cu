// One physics substep's linear algebra for Hopper: the Stable-PD solve, the
// torque-clamp correction, the Delassus operator and the projected-Jacobi
// contact solve of a batch of environments, in one launch.
//
// Replaces the TPU kernel pfpn_tpu/ops/substep_lin.py:_make_kernel (inner
// `kernel`, :136), launched by _substep_core_pallas (:240) for
// make_substep_core (:305). Per environment it computes, in the TPU
// kernel's order (:160-237):
//   Minv = (H + diag(kd dt) + eps)^-1              Gauss-Jordan sweep
//   a    = Minv f;  tau = kpe - kd dt a on the motor dofs
//   dtau = clamp(tau) - tau                        spherical norm clamp,
//                                                  revolute box clamp (:75-88)
//   Hinv = (H + eps)^-1                            second sweep
//   v*   = v + dt (a + Hinv dtau)
//   W    = Hinv J^T,  A = J W
//   step = relaxation / max(sum_j |A_ij| + cfm, 1e-9)   Gershgorin step
//   lam  = `iterations` projected-Jacobi sweeps from 0, friction cone and
//          joint-limit rows
//   out  = v* + W lam
// The TPU kernel's 128-lane batch tile, its identity padding and its
// batch-in-lanes transposes are not needed here.
//
// Bound on this card. Per env the function reads H (n^2), f, kpe, v (3n),
// J (R n), the targets (R) and the masks (K + L), and writes n floats: for
// the humanoid (n = 34, K = 16, L = 8, R = 56) 13.1 KB. It does ~0.6 MFLOP:
// two ~2 n^3 sweeps, W (2 n^2 R), A (2 n R^2) and 16 Jacobi sweeps of
// 2 R^2 each. At B = 8192 that is 107 MB (0.032 ms at 3.35 TB/s) against
// ~5 GFLOP (0.075 ms at 67 TFLOP/s): operations bound it.
// ops/substep_lin.py:substep_flops counts the work from these loops.
//
// Design. One thread block per environment. The whole workspace (Minv,
// Hinv, J, W, A and the vectors: ~38 KB for the humanoid) sits in the
// block's dynamic shared memory, so nothing but the inputs and the output
// touches device memory. Matrix-vector products and row sums split over
// rows, W and A over their elements, the Jacobi sweeps over the R rows,
// with barriers between dependent phases. Every element's arithmetic is
// the same whatever the thread count, so the host build (one thread) runs
// the kernel's numbers on the CPU. No refinement step: the TPU kernel has
// none, and the CPU tests hold this source to the bounds of the Cholesky
// reference without one.

#include "block_linalg.cuh"

#define SL_MAXD 64     // dofs
#define SL_MAXS 16     // spherical motors
#define SL_MAXR 16     // revolute motors

// Static tables; ops/substep_lin.py mirrors this layout with ctypes (all
// fields are 4 bytes wide, so there is no padding).
struct SubstepTables {
  int ndof, K, n_lim, iterations, n_sph_motors, n_rev_motors;
  int sph_motor_dof[SL_MAXS];
  int rev_motor_dof[SL_MAXR];
  float dt, mu, cfm, relaxation, eps;
  float minv_diag[SL_MAXD];   // kd dt + eps, added to the diagonal of H
  float kd_dt[SL_MAXD];       // kd dt of the torque, per dof
  float sph_motor_lim[SL_MAXS];
  float rev_motor_lim[SL_MAXR];
};

struct SubstepShared {   // offsets (floats) into the block's shared memory
  int minv, hinv, j, w, a, vec_a, dtau, vstar, step, b, lam, upd, scratch, total;
};

BL_HD SubstepShared substep_layout(int n, int R) {
  SubstepShared s;
  int o = 0;
  s.minv = o; o += n * n;
  s.hinv = o; o += n * n;
  s.j = o; o += R * n;
  s.w = o; o += n * R;
  s.a = o; o += R * R;
  s.vec_a = o; o += n;
  s.dtau = o; o += n;
  s.vstar = o; o += n;
  s.step = o; o += R;
  s.b = o; o += R;
  s.lam = o; o += R;
  s.upd = o; o += R;
  s.scratch = o; o += 2 * n;
  s.total = o;
  return s;
}

// One environment, by the threads tid = 0..nt-1 of its block. Inputs are
// this env's rows: h (n, n), f, kpe, v (n), J (R, n), tgt (R), act_n (K),
// act_l (max(L, 1)); out (n).
BL_HD void substep_env(const SubstepTables& T, const float* h, const float* f,
                       const float* kpe, const float* v, const float* J,
                       const float* tgt, const float* act_n,
                       const float* act_l, float* out, float* sh, int tid,
                       int nt) {
  const int n = T.ndof, K = T.K, K3 = 3 * T.K, R = 3 * T.K + T.n_lim;
  const SubstepShared L = substep_layout(n, R);
  float* minv = sh + L.minv;
  float* hinv = sh + L.hinv;
  float* Js = sh + L.j;
  float* W = sh + L.w;
  float* A = sh + L.a;
  float* acc = sh + L.vec_a;
  float* dtau = sh + L.dtau;
  float* vstar = sh + L.vstar;
  float* step = sh + L.step;
  float* b = sh + L.b;
  float* lam = sh + L.lam;
  float* upd = sh + L.upd;

  // ---- load H twice with its two diagonals, and J ---------------------------
  for (int e = tid; e < n * n; e += nt) {
    const float x = h[e];
    const bool diag = (e / n) == (e % n);
    minv[e] = diag ? x + T.minv_diag[e / n] : x;
    hinv[e] = diag ? x + T.eps : x;
  }
  for (int e = tid; e < R * n; e += nt) Js[e] = J[e];
  BL_SYNC();

  // ---- Minv; a = Minv f --------------------------------------------------------
  gj_sweep(minv, n, sh + L.scratch, tid, nt);
  for (int i = tid; i < n; i += nt) {
    acc[i] = dot_in_order(minv + i * n, 1, f, 1, n);
    dtau[i] = 0.0f;
  }
  BL_SYNC();

  // ---- torque clamp correction on the motor dofs -------------------------------
  for (int m = tid; m < T.n_sph_motors + T.n_rev_motors; m += nt) {
    if (m < T.n_sph_motors) {
      const int d = T.sph_motor_dof[m];
      const float lim = T.sph_motor_lim[m];
      float t3[3];
      for (int o = 0; o < 3; ++o) t3[o] = kpe[d + o] - T.kd_dt[d + o] * acc[d + o];
      const float nrm = sqrtf(t3[0] * t3[0] + t3[1] * t3[1] + t3[2] * t3[2]);
      const float scale = nrm > lim ? lim / fmaxf(nrm, 1e-9f) : 1.0f;
      for (int o = 0; o < 3; ++o) dtau[d + o] = t3[o] * scale - t3[o];
    } else {
      const int r = m - T.n_sph_motors;
      const int d = T.rev_motor_dof[r];
      const float lim = T.rev_motor_lim[r];
      const float t1 = kpe[d] - T.kd_dt[d] * acc[d];
      dtau[d] = fminf(fmaxf(t1, -lim), lim) - t1;
    }
  }

  // ---- Hinv; v* = v + dt (a + Hinv dtau) ----------------------------------------
  // (the sweep's first barrier also orders the dtau writes above before
  // their reads below)
  gj_sweep(hinv, n, sh + L.scratch, tid, nt);
  for (int i = tid; i < n; i += nt)
    vstar[i] = v[i] + T.dt * (acc[i] + dot_in_order(hinv + i * n, 1, dtau, 1, n));
  // ---- W = Hinv J^T (n, R) -------------------------------------------------------
  for (int e = tid; e < n * R; e += nt) {
    const int i = e / R, r = e % R;
    float s = 0.0f;
    for (int k = 0; k < n; ++k) s += hinv[i * n + k] * Js[r * n + k];
    W[e] = s;
  }
  BL_SYNC();

  // ---- A = J W (R, R) --------------------------------------------------------------
  for (int e = tid; e < R * R; e += nt) {
    const int r = e / R, c = e % R;
    float s = 0.0f;
    for (int k = 0; k < n; ++k) s += Js[r * n + k] * W[k * R + c];
    A[e] = s;
  }
  BL_SYNC();

  // ---- Gershgorin step, b = J v* - target, lam = 0 ----------------------------
  for (int r = tid; r < R; r += nt) {
    float rs = 0.0f;
    for (int c = 0; c < R; ++c) rs += fabsf(A[r * R + c]);
    step[r] = T.relaxation / fmaxf(rs + T.cfm, 1e-9f);
    b[r] = dot_in_order(Js + r * n, 1, vstar, 1, n) - tgt[r];
    lam[r] = 0.0f;
  }
  BL_SYNC();

  // ---- projected Jacobi --------------------------------------------------------------
  for (int it = 0; it < T.iterations; ++it) {
    for (int r = tid; r < R; r += nt)
      upd[r] = lam[r] - step[r] * (dot_in_order(A + r * R, 1, lam, 1, R) + b[r]);
    BL_SYNC();
    for (int r = tid; r < R; r += nt) {
      float x;
      if (r < K3) {
        const int c = r % K;
        const float lam_n = fmaxf(upd[c], 0.0f) * act_n[c];
        if (r < K) {
          x = lam_n;
        } else {
          const float bound = T.mu * lam_n;
          x = fminf(fmaxf(upd[r], -bound), bound) * act_n[c];
        }
      } else {
        x = fmaxf(upd[r], 0.0f) * act_l[r - K3];
      }
      lam[r] = x;
    }
    BL_SYNC();
  }

  // ---- v' = v* + W lam ----------------------------------------------------------------
  for (int i = tid; i < n; i += nt) out[i] = vstar[i] + dot_in_order(W + i * R, 1, lam, 1, R);
}

static inline size_t substep_shared_bytes(const SubstepTables& T) {
  return (size_t)substep_layout(T.ndof, 3 * T.K + T.n_lim).total * sizeof(float);
}

#ifdef __CUDACC__

__global__ void substep_lin_kernel(const SubstepTables T,
                                   const float* __restrict__ h,
                                   const float* __restrict__ f,
                                   const float* __restrict__ kpe,
                                   const float* __restrict__ v,
                                   const float* __restrict__ J,
                                   const float* __restrict__ tgt,
                                   const float* __restrict__ act_n,
                                   const float* __restrict__ act_l,
                                   float* __restrict__ out) {
  extern __shared__ float sh[];
  const size_t env = blockIdx.x;
  const int n = T.ndof, R = 3 * T.K + T.n_lim, L1 = T.n_lim > 0 ? T.n_lim : 1;
  substep_env(T, h + env * n * n, f + env * n, kpe + env * n, v + env * n,
              J + env * R * n, tgt + env * R, act_n + env * T.K,
              act_l + env * L1, out + env * n, sh, threadIdx.x, blockDim.x);
}

// One substep for B envs on `stream`; returns cudaGetLastError() (0 =
// launched).
extern "C" int pfpn_substep_lin_launch(const void* tables, const float* h,
                                       const float* f, const float* kpe,
                                       const float* v, const float* J,
                                       const float* tgt, const float* act_n,
                                       const float* act_l, float* out, int B,
                                       void* stream) {
  if (B <= 0) return 0;
  const SubstepTables& T = *(const SubstepTables*)tables;
  const size_t shared = substep_shared_bytes(T);
  if (shared > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        substep_lin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int threads = 128;
  substep_lin_kernel<<<B, threads, shared, (cudaStream_t)stream>>>(
      T, h, f, kpe, v, J, tgt, act_n, act_l, out);
  return (int)cudaGetLastError();
}

#else

#include <vector>

// Host build of the same body (g++ -x c++), for the CPU tests.
extern "C" int pfpn_substep_lin_host(const void* tables, const float* h,
                                     const float* f, const float* kpe,
                                     const float* v, const float* J,
                                     const float* tgt, const float* act_n,
                                     const float* act_l, float* out, int B) {
  const SubstepTables& T = *(const SubstepTables*)tables;
  const int n = T.ndof, R = 3 * T.K + T.n_lim, L1 = T.n_lim > 0 ? T.n_lim : 1;
  std::vector<float> sh(substep_shared_bytes(T) / sizeof(float));
  for (size_t env = 0; env < (size_t)B; ++env)
    substep_env(T, h + env * n * n, f + env * n, kpe + env * n, v + env * n,
                J + env * R * n, tgt + env * R, act_n + env * T.K,
                act_l + env * L1, out + env * n, sh.data(), 0, 1);
  return 0;
}

#endif

extern "C" int pfpn_substep_lin_tables_bytes(void) { return (int)sizeof(SubstepTables); }
