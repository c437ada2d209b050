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
// Design for the humanoid's shape, (n, K, L) = (34, 16, 8), R = 56: the
// only shape the port builds; the shape is a template parameter, so every
// index and loop bound is a constant. One block of two warps per env; 8
// blocks fit on an SM (22,432 bytes of shared memory and 128 registers a
// thread).
//   * Both inverses in one sweep: Minv and Hinv do not depend on each
//     other, so warp 0 inverts H + diag(kd dt) + eps and warp 1 H + eps at
//     the same time, each in registers (gj_warp_sweep, block_linalg.cuh):
//     one __syncwarp() per pivot, no block barrier; lane l holds column l
//     and rows l, l + 32 of columns 32 and 33. Column j of the sweep's
//     output is taken as row j of the inverse: for a symmetric matrix that
//     is Gauss-Jordan by column operations, as exact as by row operations,
//     and it makes a = Minv f an in-register dot per lane.
//   * W^T = J Hinv^T (56 x 34; W^T row r = Hinv J_r) by one thread per
//     contact row, J_r in registers, Hinv's rows read as broadcasts; then
//     only A's upper triangle, A[r][c] = J_r . W^T_c for c >= r, by one
//     thread per row, mirrored as it is stored, so the row sums and the
//     Jacobi products read whole rows. Rows have odd (A) or 16-byte
//     (J, Hinv, W^T) strides against bank conflicts.
//   * Jacobi: one lane per row, 56 of the 64 busy, each with its row of A,
//     its Gershgorin step and b in registers; a warp holds eight contacts'
//     three rows (normal c, friction K + c and 2K + c) and four limit rows,
//     so the friction cone's projection reads the normal row's update after
//     a __syncwarp(); lambda is double-buffered in shared memory and read as
//     broadcasts, so a sweep costs one block barrier. Each row's product
//     runs as two partial sums (even and odd terms).
//   * Shared memory is reused as values die: A takes the space of J and
//     Hinv, the sweeps' column buffers that of W^T. No refinement: the TPU
//     kernel has none, and the CPU tests hold this source to the bounds of
//     the Cholesky reference without one.
// Every other shape runs the first design as its own kernel: one 128-thread
// block per env, its workspace (~38 KB for the humanoid) in dynamic shared
// memory, two barriers per Gauss-Jordan pivot, the Jacobi sweeps over the
// rows with two barriers a sweep.
//
// The host build (g++, the CPU tests) runs the same bodies on host threads
// with std::barrier for the card's syncs: the two-warp body on 64 threads
// (a barrier per warp for __syncwarp, one for the block) or on one thread
// that runs the 64 lanes; the first design's body on any thread count.

#include <math.h>
#include <stddef.h>

#if defined(__CUDA_ARCH__) || defined(__CUDACC__)
// nvcc: block_linalg.cuh's defaults (__syncthreads, __syncwarp on the card)
#else
#include <barrier>
#include <thread>
#include <vector>
// the host build's barriers: the block's, and the thread's warp's
static thread_local std::barrier<>* sl_block_barrier = nullptr;
static thread_local std::barrier<>* sl_warp_barrier = nullptr;
static inline void sl_host_sync(std::barrier<>* b) {
  if (b) b->arrive_and_wait();
}
#define BL_SYNC() sl_host_sync(sl_block_barrier)
#define BL_WSYNC() sl_host_sync(sl_warp_barrier)
#endif
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

// ---- the humanoid's shape: two warps per env ----------------------------------------

#define SL_N 34        // dofs
#define SL_K 16        // contacts
#define SL_L 8         // joint-limit rows
#define SL_THREADS 128   // threads per block of the first design's kernel
#define SL_MIN_BLOCKS 8  // __launch_bounds__'s blocks per SM for the two-warp kernel

// Offsets (floats) into the block's shared memory.
template <int N, int K, int L> struct SlLayout {
  static constexpr int R = 3 * K + L, K4 = (K + 3) & ~3, L4 = (L + 3) & ~3;
  static constexpr int R4 = (R + 3) & ~3;
  static constexpr int LDJ = (N + 3) & ~3;       // J, Hinv and W^T rows
  static constexpr int LDA = R | 1;              // A rows
  static constexpr int j = 0;                    // J (R x LDJ)
  static constexpr int hinv = R * LDJ;           // Hinv (N x LDJ)
  static constexpr int a = 0;                    // A (R x LDA), over J and Hinv
  static constexpr int jh = hinv + N * LDJ;
  static constexpr int wt = (jh > R * LDA ? jh : R * LDA + 3) & ~3;   // W^T (R x LDJ)
  static constexpr int buf = wt;                 // the sweeps' column buffers
  static constexpr int xc = buf + 4 * BlWarpShape<N>::LDB;   // Minv's last rows
  static constexpr int f = wt + R * LDJ;
  static constexpr int acc = f + LDJ;            // a = Minv f
  static constexpr int dtau = acc + LDJ;
  static constexpr int vstar = dtau + LDJ;
  static constexpr int b = vstar + LDJ;
  static constexpr int lam = b + R4;             // two buffers of R4
  static constexpr int updn = lam + 2 * R4;      // normal rows' updates
  static constexpr int actn = updn + K4;
  static constexpr int actl = actn + K4;
  static constexpr int total = actl + L4;
  static_assert(4 * BlWarpShape<N>::LDB + (N - 32) * LDJ <= R * LDJ,
                "the column buffers and Minv's last rows fit in W^T's space");
  static_assert(K % 2 == 0 && L % 2 == 0 && 3 * K / 2 + L / 2 <= 32,
                "a warp holds half the contacts' rows and half the limit rows");
};

// The Jacobi row of lane g (-1: none): in warp w, lanes 0..K/2-1 take the
// normal rows of contacts w K/2 .. (w + 1) K/2 - 1, the next K/2 lanes their
// first friction rows, the next K/2 their second, then L/2 limit rows.
template <int K, int L>
BL_HD int sl_jacobi_row(int g) {
  constexpr int hk = K / 2, hl = L / 2;
  const int w = g >> 5, l = g & 31;
  if (l < 3 * hk) return (l / hk) * K + hk * w + l % hk;
  if (l < 3 * hk + hl) return 3 * K + hl * w + (l - 3 * hk);
  return -1;
}

// sum_c x[c] y[c] over c = 0..M-1 (M a multiple of 4): two partial sums,
// of the even and of the odd terms in c order (the first product, then one
// multiply-add per term), so that the chain of dependent multiply-adds is
// half as long; x in registers, y in shared memory (16-byte aligned) read
// four floats at a time.
template <int M>
BL_HD float sl_dot_reg2(const float* x, const float* y) {
  static_assert(M % 4 == 0, "whole 16-byte groups");
  float e = 0.0f, o = 0.0f;
  BL_UNROLL
  for (int c0 = 0; c0 < M; c0 += 4) {
    float t[4];
    bl_ld4(y + c0, t);
    e = c0 == 0 ? x[0] * t[0] : fmaf(x[c0], t[0], e);
    o = c0 == 0 ? x[1] * t[1] : fmaf(x[c0 + 1], t[1], o);
    e = fmaf(x[c0 + 2], t[2], e);
    o = fmaf(x[c0 + 3], t[3], o);
  }
  return e + o;
}

// One environment by the 64 lanes of two warps, run by `nt` threads of LPT
// lanes each (nt LPT = 64). Inputs and output as substep_env's.
template <int N, int K, int L, int LPT>
BL_HD void substep_env_warps(const SubstepTables& T, const float* h, const float* f,
                             const float* kpe, const float* v, const float* J,
                             const float* tgt, const float* act_n,
                             const float* act_l, float* out, float* sh, int tid,
                             int nt) {
  using Y = SlLayout<N, K, L>;
  constexpr int R = Y::R, K3 = 3 * K, LDJ = Y::LDJ, LDA = Y::LDA;
  constexpr int XC = BlWarpShape<N>::XC, NT = 64;
  float* sJ = sh + Y::j;
  float* sHinv = sh + Y::hinv;
  float* sA = sh + Y::a;
  float* sWT = sh + Y::wt;
  float* sf = sh + Y::f;
  float* sacc = sh + Y::acc;
  float* sdtau = sh + Y::dtau;
  float* svstar = sh + Y::vstar;
  float* sb = sh + Y::b;
  float* slam = sh + Y::lam;
  float* supdn = sh + Y::updn;
  float* sactn = sh + Y::actn;
  float* sactl = sh + Y::actl;

  // ---- load: warp 0 H + diag(kd dt + eps), warp 1 H + eps, by columns into
  // registers; J, f, the masks into shared memory; dtau = 0, lambda = 0 ------
  float c[LPT][N], x[LPT][2][XC];
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt, w = g >> 5, l = g & 31;
    BL_UNROLL
    for (int i = 0; i < N; ++i) {
      const float v0 = h[i * N + l];
      c[q][i] = i != l ? v0 : w == 0 ? v0 + T.minv_diag[i] : v0 + T.eps;
    }
    BL_UNROLL
    for (int hh = 0; hh < 2; ++hh) {
      const int i = l + 32 * hh;
      BL_UNROLL
      for (int e = 0; e < XC; ++e) {
        const float v0 = i < N ? h[i * N + 32 + e] : 0.0f;
        x[q][hh][e] = i != 32 + e ? v0 : w == 0 ? v0 + T.minv_diag[i] : v0 + T.eps;
      }
    }
    for (int e = g; e < R * N; e += NT) sJ[(e / N) * LDJ + e % N] = J[e];
    for (int i = g; i < N; i += NT) {
      sf[i] = f[i];
      sdtau[i] = 0.0f;
    }
    for (int i = g; i < K; i += NT) sactn[i] = act_n[i];
    for (int i = g; i < L; i += NT) sactl[i] = act_l[i];
    for (int r = g; r < R; r += NT) slam[r] = 0.0f;
  }

  // ---- both inverses, one per warp ----------------------------------------------
  gj_warp_sweep<N, LPT>(c, x, sh + Y::buf, tid, nt);
  BL_SYNC();

  // ---- warp 0: a = Minv f; warp 1: Hinv's rows to shared memory ------------
  // (row j of an inverse is the sweep's column j: lane l's for j < 32, the
  // lanes' rows of the last XC columns for j = 32 + e)
  float* sxc = sh + Y::xc;
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt, l = g & 31;
    if (g < 32) {
      sacc[l] = bl_dot_reg<N>(c[q], sf);
    } else {
      float* row = sHinv + l * LDJ;
      BL_UNROLL
      for (int i = 0; i + 4 <= N; i += 4)
        bl_st4(row + i, c[q][i], c[q][i + 1], c[q][i + 2], c[q][i + 3]);
      BL_UNROLL
      for (int i = N & ~3; i < N; ++i) row[i] = c[q][i];
    }
    float* last = g < 32 ? sxc : sHinv + 32 * LDJ;
    BL_UNROLL
    for (int hh = 0; hh < 2; ++hh) {
      const int i = l + 32 * hh;
      if (i >= N) continue;
      BL_UNROLL
      for (int e = 0; e < XC; ++e) last[e * LDJ + i] = x[q][hh][e];
    }
  }
  BL_WSYNC();
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt;
    if (g < XC) {
      float mr[N];
      bl_row<N>(sxc + g * LDJ, mr);
      sacc[32 + g] = bl_dot_reg<N>(mr, sf);
    }
  }
  BL_SYNC();

  // ---- torque clamp correction on the motor dofs --------------------------------
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt;
    for (int m = g; m < T.n_sph_motors + T.n_rev_motors; m += NT) {
      if (m < T.n_sph_motors) {
        const int d = T.sph_motor_dof[m];
        const float lim = T.sph_motor_lim[m];
        float t3[3];
        for (int o = 0; o < 3; ++o) t3[o] = kpe[d + o] - T.kd_dt[d + o] * sacc[d + o];
        const float nrm = sqrtf(t3[0] * t3[0] + t3[1] * t3[1] + t3[2] * t3[2]);
        const float scale = nrm > lim ? lim / fmaxf(nrm, 1e-9f) : 1.0f;
        for (int o = 0; o < 3; ++o) sdtau[d + o] = t3[o] * scale - t3[o];
      } else {
        const int r = m - T.n_sph_motors;
        const int d = T.rev_motor_dof[r];
        const float lim = T.rev_motor_lim[r];
        const float t1 = kpe[d] - T.kd_dt[d] * sacc[d];
        sdtau[d] = fminf(fmaxf(t1, -lim), lim) - t1;
      }
    }
  }
  BL_SYNC();

  // ---- v* = v + dt (a + Hinv dtau); W^T row r = Hinv J_r ------------------------
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt;
    if (g < N) {
      float hr[N];
      bl_row<N>(sHinv + g * LDJ, hr);
      svstar[g] = v[g] + T.dt * (sacc[g] + bl_dot_reg<N>(hr, sdtau));
    }
    if (g < R) {
      float jr[N], wr[N];
      bl_row<N>(sJ + g * LDJ, jr);
      BL_UNROLL
      for (int i = 0; i < N; ++i) wr[i] = bl_dot_reg<N>(jr, sHinv + i * LDJ);
      float* row = sWT + g * LDJ;
      BL_UNROLL
      for (int i = 0; i + 4 <= N; i += 4) bl_st4(row + i, wr[i], wr[i + 1], wr[i + 2], wr[i + 3]);
      BL_UNROLL
      for (int i = N & ~3; i < N; ++i) row[i] = wr[i];
    }
  }
  BL_SYNC();

  // ---- J rows into registers; b = J v* - target ----------------------------------
  float jA[LPT][N];
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt;
    if (g < R) {
      bl_row<N>(sJ + g * LDJ, jA[q]);
      sb[g] = bl_dot_reg<N>(jA[q], svstar) - tgt[g];
    }
  }
  BL_SYNC();   // J is dead: A takes its space

  // ---- A's upper triangle, A[r][c] = J_r . W^T_c (c >= r), stored mirrored -----
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt;
    if (g >= R) continue;
    for (int cc = g & ~31; cc < R; ++cc) {   // W^T rows read as broadcasts
      if (cc < g) continue;
      const float x = bl_dot_reg<N>(jA[q], sWT + cc * LDJ);
      sA[g * LDA + cc] = x;
      sA[cc * LDA + g] = x;
    }
  }
  BL_SYNC();

  // ---- projected Jacobi: each lane's row of A, its step and b in registers,
  // lambda double-buffered in shared memory ----------------------------------
  float arow[LPT][R], step[LPT], brow[LPT], lam[LPT];
  BL_UNROLL
  for (int q = 0; q < LPT; ++q) {
    const int r = sl_jacobi_row<K, L>(tid + q * nt);
    if (r < 0) continue;
    float rs = 0.0f;             // Gershgorin row sum, in c order
    BL_UNROLL
    for (int cc = 0; cc < R; ++cc) {
      arow[q][cc] = sA[r * LDA + cc];
      rs += fabsf(arow[q][cc]);
    }
    step[q] = T.relaxation / fmaxf(rs + T.cfm, 1e-9f);
    brow[q] = sb[r];
    lam[q] = 0.0f;
  }
  const int Y4 = Y::R4;
  for (int it = 0; it < T.iterations; ++it) {
    const float* lo = slam + (it & 1) * Y4;
    float* ln = slam + ((it + 1) & 1) * Y4;
    float u[LPT];
    BL_UNROLL
    for (int q = 0; q < LPT; ++q) {
      const int r = sl_jacobi_row<K, L>(tid + q * nt);
      if (r < 0) continue;
      u[q] = lam[q] - step[q] * (sl_dot_reg2<R>(arow[q], lo) + brow[q]);
      if (r < K) supdn[r] = u[q];
    }
    BL_WSYNC();
    BL_UNROLL
    for (int q = 0; q < LPT; ++q) {
      const int r = sl_jacobi_row<K, L>(tid + q * nt);
      if (r < 0) continue;
      float x;
      if (r < K3) {
        const int cc = r % K;
        const float lam_n = fmaxf((r < K ? u[q] : supdn[cc]), 0.0f) * sactn[cc];
        if (r < K) {
          x = lam_n;
        } else {
          const float bound = T.mu * lam_n;
          x = fminf(fmaxf(u[q], -bound), bound) * sactn[cc];
        }
      } else {
        x = fmaxf(u[q], 0.0f) * sactl[r - K3];
      }
      lam[q] = x;
      ln[r] = x;
    }
    BL_SYNC();
  }

  // ---- v' = v* + W lambda ------------------------------------------------------------
  const float* lf = slam + (T.iterations & 1) * Y4;
  for (int q = 0; q < LPT; ++q) {
    const int g = tid + q * nt;
    if (g < N) {
      float s = 0.0f;
      BL_UNROLL
      for (int r0 = 0; r0 < R; r0 += 4) {
        float t[4];
        bl_ld4(lf + r0, t);
        BL_UNROLL
        for (int u = 0; u < 4; ++u)
          if (r0 + u < R)
            s = r0 + u == 0 ? sWT[g] * t[0] : fmaf(sWT[(r0 + u) * LDJ + g], t[u], s);
      }
      out[g] = svstar[g] + s;
    }
  }
}

static inline bool substep_warps_shape(const SubstepTables& T) {
  return T.ndof == SL_N && T.K == SL_K && T.n_lim == SL_L;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(64, SL_MIN_BLOCKS)
substep_lin_warps_kernel(const SubstepTables T, const float* __restrict__ h,
                         const float* __restrict__ f, const float* __restrict__ kpe,
                         const float* __restrict__ v, const float* __restrict__ J,
                         const float* __restrict__ tgt, const float* __restrict__ act_n,
                         const float* __restrict__ act_l, float* __restrict__ out) {
  constexpr int n = SL_N, R = 3 * SL_K + SL_L;
  __shared__ __align__(16) float sh[SlLayout<SL_N, SL_K, SL_L>::total];
  const size_t env = blockIdx.x;
  substep_env_warps<SL_N, SL_K, SL_L, 1>(
      T, h + env * n * n, f + env * n, kpe + env * n, v + env * n, J + env * R * n,
      tgt + env * R, act_n + env * SL_K, act_l + env * SL_L, out + env * n, sh,
      threadIdx.x, 64);
}

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

// One substep for B envs on `stream`: the two-warp kernel for the
// humanoid's shape, the first design's kernel otherwise. Returns
// cudaGetLastError() (0 = launched).
extern "C" int pfpn_substep_lin_launch(const void* tables, const float* h,
                                       const float* f, const float* kpe,
                                       const float* v, const float* J,
                                       const float* tgt, const float* act_n,
                                       const float* act_l, float* out, int B,
                                       void* stream) {
  if (B <= 0) return 0;
  const SubstepTables& T = *(const SubstepTables*)tables;
  if (substep_warps_shape(T)) {
    substep_lin_warps_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(
        T, h, f, kpe, v, J, tgt, act_n, act_l, out);
    return (int)cudaGetLastError();
  }
  const size_t shared = substep_shared_bytes(T);
  if (shared > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        substep_lin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (rc != cudaSuccess) return (int)rc;
  }
  substep_lin_kernel<<<B, SL_THREADS, shared, (cudaStream_t)stream>>>(
      T, h, f, kpe, v, J, tgt, act_n, act_l, out);
  return (int)cudaGetLastError();
}

#else

// Host build of the same bodies (g++ -x c++), for the CPU tests. For the
// humanoid's shape `threads` is 64 (the two warps' lanes, one host thread
// each, with a std::barrier per warp for __syncwarp and one for the block)
// or 1 (one thread runs the 64 lanes); for any other shape, any count of
// host threads runs the first design's body with a std::barrier for
// __syncthreads. Returns 1 if `threads` is refused.
extern "C" int pfpn_substep_lin_host(const void* tables, const float* h,
                                     const float* f, const float* kpe,
                                     const float* v, const float* J,
                                     const float* tgt, const float* act_n,
                                     const float* act_l, float* out, int B,
                                     int threads) {
  const SubstepTables& T = *(const SubstepTables*)tables;
  const bool warps = substep_warps_shape(T);
  if (threads < 1 || (warps && threads != 1 && threads != 64)) return 1;
  const int n = T.ndof, R = 3 * T.K + T.n_lim, L1 = T.n_lim > 0 ? T.n_lim : 1;
  std::vector<float> sh((warps ? SlLayout<SL_N, SL_K, SL_L>::total
                               : substep_shared_bytes(T) / sizeof(float)) + 4);
  float* base = sh.data();    // 16-byte alignment for the vector accesses
  while (reinterpret_cast<size_t>(base) % 16) ++base;
  std::barrier<> block(threads), warp0(threads > 1 ? 32 : 1), warp1(threads > 1 ? 32 : 1);
  auto body = [&](int tid) {
    sl_block_barrier = threads > 1 ? &block : nullptr;
    sl_warp_barrier = warps && threads > 1 ? (tid < 32 ? &warp0 : &warp1) : nullptr;
    for (size_t env = 0; env < (size_t)B; ++env) {
      const float *he = h + env * n * n, *fe = f + env * n, *ke = kpe + env * n,
                  *ve = v + env * n, *Je = J + env * R * n, *te = tgt + env * R,
                  *ane = act_n + env * T.K, *ale = act_l + env * L1;
      float* oe = out + env * n;
      if (!warps)
        substep_env(T, he, fe, ke, ve, Je, te, ane, ale, oe, base, tid, threads);
      else if (threads == 1)
        substep_env_warps<SL_N, SL_K, SL_L, 64>(T, he, fe, ke, ve, Je, te, ane, ale,
                                                oe, base, 0, 1);
      else
        substep_env_warps<SL_N, SL_K, SL_L, 1>(T, he, fe, ke, ve, Je, te, ane, ale,
                                               oe, base, tid, 64);
      BL_SYNC();   // the next env reuses the workspace
    }
    sl_block_barrier = sl_warp_barrier = nullptr;
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(body, t);
  body(0);
  for (auto& th : pool) th.join();
  return 0;
}

#endif

extern "C" int pfpn_substep_lin_tables_bytes(void) { return (int)sizeof(SubstepTables); }

// Threads per env on the card for these tables: 64 for the humanoid's
// shape, SL_THREADS otherwise.
extern "C" int pfpn_substep_lin_block_threads(const void* tables) {
  return substep_warps_shape(*(const SubstepTables*)tables) ? 64 : SL_THREADS;
}
