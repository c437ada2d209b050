// The 30 Hz control step ("megastep") for Hopper: FK, mass matrix, bias
// forces, Stable-PD, ground contacts and integration for frame_skip
// substeps of a batch of environments, in one launch.
//
// Replaces the TPU kernel pfpn_tpu/ops/megastep.py:_make_kernel (inner
// `kernel`, :406), launched by megastep_pallas (:1157), in both of its
// variants: the default one, and emit_links (:994-1077), which also writes
// the final link states (link_epilogue below). Per substep it runs
// the TPU kernel's stages in its order: FK; velocity rows and Jacobian
// columns; per-body inertias; H over the static ancestor-pair sparsity; C
// by the fixed-frame bias recursion; SPD errors -> f; two unpivoted in-place
// Gauss-Jordan inverses, of (H + diag(kd dt) + eps) and (H + eps), with the
// torque-clamp correction; candidate points and top-K by iterative argmin
// with the static tie-break (c+1)*1e-7; W = Hinv J^T, Gershgorin row sums
// and projected-Jacobi sweeps in W-form; integration with exp-map
// quaternions, the +-100 cap and the revolute clamps. Where it departs
// from the TPU kernel it is for fp32 accuracy against the plain version,
// and each place says so: H and C in the base frame, H from
// centre-of-mass composites, one refinement step per inverse solve, true
// (untied) distances for flags and targets. atan2f replaces the TPU
// kernel's atan polynomial.
//
// Bound on this card. The function moves ~1 KB per env (state, targets in;
// state, flags, base history out) but does ~11 MFLOP of fp32 arithmetic
// per env per control step for the humanoid (ndof 34, K 16, 56 rows; per
// substep ~155 K in the two 34^3 sweeps, ~111 K for W, ~83 K for the
// upper-triangle Delassus row sums, ~123 K for 16 Jacobi sweeps, ~60 K for
// the rest; ops/megastep.py:megastep_flops counts it from these loops).
// At the H100's 67 TFLOP/s fp32 outside the tensor cores that is ~1.3 ms
// for B = 8192: bound by operations, not bytes.
//
// Design. Correct first: one env per thread, so every loop below is the
// per-env loop of the TPU kernel with the batch moved from lanes to
// threads. The static tree, gain and contact tables (MegaTables, built once
// per engine by ops/megastep.py) are copied into shared memory per block
// and read as broadcasts; the loops run over them, so one file serves any
// tree within the MS_MAX* limits. The per-env matrices (two n x n inverses
// and H, the 3K x n contact rows, the n x R W) do not fit in registers:
// they live in a global workspace laid out batch-innermost,
// ws[(i*N + j)*B + env], so neighbouring threads touch neighbouring
// addresses (the GPU's form of the TPU's batch-in-lanes). That makes this
// first version bound in practice by workspace traffic (~1.6 MB per env
// per substep through L2 and HBM) and by latency (B = 8192 threads fill a
// twentieth of the card's thread slots), far above the fp32 bound; the next
// step is a warp per env with the matrices in shared memory. Built without
// --use_fast_math: approximate sqrt, division and exp shift knife-edge
// contacts.
//
// The same per-env body compiles as plain C++ (g++ -x c++) into a host
// library, so the CPU tests hold this source's arithmetic against the
// PyTorch plain version without a card.

#include <math.h>
#include <stddef.h>
#include <stdint.h>

// every per-env function is inlined into the one kernel, so the whole body
// is one frame whose size ptxas reports (-Xptxas -v)
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MS_HD __host__ __device__ __forceinline__
#define MS_HD_CALL __host__ __device__ __noinline__
#else
#define MS_HD inline
#define MS_HD_CALL
#endif

#define MS_MAXB 16     // bodies
#define MS_MAXD 40     // dofs
#define MS_MAXC 48     // contact candidates
#define MS_MAXK 16     // selected contacts (K)
#define MS_MAXL 8      // joint-limit rows
#define MS_MAXS 12     // spherical joints
#define MS_MAXR 8      // revolute joints
#define MS_MAXLK 16    // URDF links (the emit_links output)
#define MS_LINK_ROWS 20
#define MS_MAXROWS (3 * MS_MAXK + MS_MAXL)
#define MS_MAXST (13 + 7 * MS_MAXS + 2 * MS_MAXR)

// Static tables; ops/megastep.py mirrors this layout with ctypes (all
// fields are 4 bytes wide, so there is no padding).
struct MegaTables {
  int ndof, nb, n_sph, n_rev, n_cand, K, n_lim, frame_skip, up, iterations;
  int n_sph_motors, n_rev_motors;
  int topo[MS_MAXB];            // non-root bodies, parents first (nb - 1)
  int parent[MS_MAXB];
  int jtype[MS_MAXB];           // 0 free, 1 spherical, 2 revolute
  int sph_index[MS_MAXB];
  int rev_index[MS_MAXB];
  int dof_offset[MS_MAXB];
  int dof_count[MS_MAXB];
  unsigned int anc[MS_MAXB];    // bit j: body j is an ancestor-or-self of b
  int dof_body[MS_MAXD];
  int dof_is_linear[MS_MAXD];
  int sph_body[MS_MAXS];
  int rev_body[MS_MAXR];
  int sph_motor_dof[MS_MAXS];
  int sph_motor_idx[MS_MAXS];
  int rev_motor_dof[MS_MAXR];
  int rev_motor_idx[MS_MAXR];
  int rev_has_limit[MS_MAXR];
  int cand_body[MS_MAXC];
  int lim_dof[MS_MAXL];
  int lim_rev[MS_MAXL];
  float dt, mu, slop, relaxation, cfm, eps, erp_dt, limit_erp_dt;
  float gravity[3];
  float joint_pos[MS_MAXB][3];
  float joint_quat[MS_MAXB][4];
  float joint_axis[MS_MAXB][3];
  float mass[MS_MAXB];
  float com[MS_MAXB][3];
  float inertia_c[MS_MAXB][9];
  float dof_axis[MS_MAXD][3];
  float kp[MS_MAXD];
  float kd[MS_MAXD];
  float kd_dt[MS_MAXD];
  float minv_diag[MS_MAXD];     // kd*dt + eps, rounded once from double
  float sph_motor_lim[MS_MAXS];
  float rev_motor_lim[MS_MAXR];
  float rev_lo[MS_MAXR];
  float rev_hi[MS_MAXR];
  float cand_off[MS_MAXC][3];
  float cand_radius[MS_MAXC];
  float cand_tie[MS_MAXC];      // (c + 1) * 1e-7
  float lim_val[MS_MAXL];
  float lim_sign[MS_MAXL];
  // URDF links, read only by the emit_links epilogue
  int n_links;
  int link_body[MS_MAXLK];
  float link_pos[MS_MAXLK][3];
  float link_quat[MS_MAXLK][4];
  float link_ipos[MS_MAXLK][3];
  float link_iquat[MS_MAXLK][4];
};

// ---- small algebra -------------------------------------------------------

MS_HD static void qmul(const float* a, const float* b, float* o) {
  const float x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
  const float x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
  o[0] = w2 * x1 + x2 * w1 - y2 * z1 + z2 * y1;
  o[1] = w2 * y1 + x2 * z1 + y2 * w1 - z2 * x1;
  o[2] = w2 * z1 - x2 * y1 + y2 * x1 + z2 * w1;
  o[3] = w2 * w1 - x2 * x1 - y2 * y1 - z2 * z1;
}

MS_HD static void qnormalize(float* q) {
  const float nn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float inv = 1.0f / fmaxf(nn, 1e-8f);
  q[0] *= inv; q[1] *= inv; q[2] *= inv; q[3] *= inv;
}

// row-major 3x3 rotation of a unit quaternion
MS_HD static void q2R(const float* q, float* R) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}

MS_HD static void Rv(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

MS_HD static void Rtv(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
}

MS_HD static void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// exp map of (w * scale) as a quaternion
MS_HD static void qexp_scaled(const float* w, float scale, float* q) {
  const float v0 = w[0] * scale, v1 = w[1] * scale, v2 = w[2] * scale;
  const float ang = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
  const float half = 0.5f * ang;
  const float k = ang > 1e-6f ? sinf(half) / fmaxf(ang, 1e-8f) : 0.5f;
  q[0] = v0 * k; q[1] = v1 * k; q[2] = v2 * k; q[3] = cosf(half);
}

// shortest-path axis*angle of a quaternion
MS_HD static void q_axis_angle(const float* q, float* e) {
  const float sgn = q[3] < 0.0f ? -1.0f : 1.0f;
  const float x = q[0] * sgn, y = q[1] * sgn, z = q[2] * sgn, w = q[3] * sgn;
  const float s = sqrtf(x * x + y * y + z * z);
  const float wc = fminf(fmaxf(w, 0.0f), 1.0f);
  const float ang = 2.0f * atan2f(s, wc);
  const float k = s > 1e-8f ? ang / fmaxf(s, 1e-8f) : 0.0f;
  e[0] = x * k; e[1] = y * k; e[2] = z * k;
}

// spatial cross products on (ang; lin) 6-vectors
MS_HD static void crm6(const float* v, const float* u, float* o) {
  float a[3], b[3];
  cross3(v, u, o);
  cross3(v, u + 3, a);
  cross3(v + 3, u, b);
  for (int i = 0; i < 3; ++i) o[3 + i] = a[i] + b[i];
}

MS_HD static void crf6(const float* v, const float* f, float* o) {
  float a[3], b[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  for (int i = 0; i < 3; ++i) o[i] = a[i] + b[i];
  cross3(v, f + 3, o + 3);
}

// FK over the static tree from the base pose (q0, p0): every body's
// quaternion q, position p and rotation matrix R
MS_HD static void fk_pass_q(const MegaTables& T, const float* q_sph,
                            const float* q_rev, const float* q0, const float* p0,
                            float (*q)[4], float (*p)[3], float (*R)[9]) {
  for (int i = 0; i < 4; ++i) q[0][i] = q0[i];
  for (int i = 0; i < 3; ++i) p[0][i] = p0[i];
  q2R(q[0], R[0]);
  for (int t = 0; t < T.nb - 1; ++t) {
    const int b = T.topo[t], par = T.parent[b];
    float qj[4], rel[4], off[3];
    if (T.jtype[b] == 1) {
      for (int i = 0; i < 4; ++i) qj[i] = q_sph[4 * T.sph_index[b] + i];
    } else {
      const float half = 0.5f * q_rev[T.rev_index[b]];
      const float sh = sinf(half), ch = cosf(half);
      qj[0] = T.joint_axis[b][0] * sh;
      qj[1] = T.joint_axis[b][1] * sh;
      qj[2] = T.joint_axis[b][2] * sh;
      qj[3] = ch;
    }
    qmul(T.joint_quat[b], qj, rel);
    qmul(q[par], rel, q[b]);
    qnormalize(q[b]);
    q2R(q[b], R[b]);
    Rv(R[par], T.joint_pos[b], off);
    for (int i = 0; i < 3; ++i) p[b][i] = p[par][i] + off[i];
  }
}

MS_HD static void fk_pass(const MegaTables& T, const float* q_sph,
                          const float* q_rev, const float* q0, const float* p0,
                          float (*p)[3], float (*R)[9]) {
  float q[MS_MAXB][4];
  fk_pass_q(T, q_sph, q_rev, q0, p0, q, p, R);
}

// J += m (|r|^2 1 - r r^T): the parallel-axis term of a mass m at r
MS_HD static void add_parallel_axis(float* J, float m, const float* r) {
  const float rr = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      J[3 * i + j] += m * ((i == j ? rr : 0.0f) - r[i] * r[j]);
}

// motion column of dof d about the point o: (a; (p - o) x a) for a
// rotation about the axis a through the body origin p, (0; a) for a slide
MS_HD static void col_about(const MegaTables& T, const float (*col)[6],
                                   const float (*pb)[3], const float* o, int d,
                                   float* a, float* l) {
  if (T.dof_is_linear[d]) {
    for (int i = 0; i < 3; ++i) { a[i] = 0.0f; l[i] = col[d][3 + i]; }
    return;
  }
  const float* p = pb[T.dof_body[d]];
  const float r[3] = {p[0] - o[0], p[1] - o[1], p[2] - o[2]};
  for (int i = 0; i < 3; ++i) a[i] = col[d][i];
  cross3(r, a, l);
}

// ---- workspace (batch-innermost) ------------------------------------------

struct Workspace {
  float* base;
  size_t B;
  size_t env;
  MS_HD float& at(size_t off) const { return base[off * B + env]; }
};

#define GJ_CHUNK 8

// in-place unpivoted Gauss-Jordan inverse of an n x n block at `off`
// (ops/megastep.py:_sweep): pivots k = 0..n-1, then negate
MS_HD static void gj_sweep(const Workspace& ws, size_t off, int n) {
  float row_k[MS_MAXD], col_k[MS_MAXD];
  for (int kk = 0; kk < n; ++kk) {
    const float inv_d = 1.0f / ws.at(off + (size_t)kk * n + kk);
    for (int j = 0; j < n; ++j) {
      row_k[j] = ws.at(off + (size_t)kk * n + j) * inv_d;
      col_k[j] = ws.at(off + (size_t)j * n + kk);
    }
    // rank-1 update of every row but kk (column kk is overwritten below).
    // Loads and stores share one pointer, so the compiler keeps each load
    // behind the previous store; loading GJ_CHUNK elements before storing
    // any puts that many loads in flight instead of one.
    for (int i = 0; i < n; ++i) {
      if (i == kk) continue;
      const float ci = col_k[i];
      const size_t row = off + (size_t)i * n;
      for (int j0 = 0; j0 < n; j0 += GJ_CHUNK) {
        float x[GJ_CHUNK];
#pragma unroll
        for (int c = 0; c < GJ_CHUNK; ++c)
          if (j0 + c < n) x[c] = ws.at(row + j0 + c);
#pragma unroll
        for (int c = 0; c < GJ_CHUNK; ++c)
          if (j0 + c < n) ws.at(row + j0 + c) = x[c] - ci * row_k[j0 + c];
      }
    }
    for (int j = 0; j < n; ++j) ws.at(off + (size_t)kk * n + j) = row_k[j];
    for (int i = 0; i < n; ++i) ws.at(off + (size_t)i * n + kk) = col_k[i] * inv_d;
    ws.at(off + (size_t)kk * n + kk) = -inv_d;
  }
  for (size_t i = 0; i < (size_t)n * n; ++i) ws.at(off + i) = -ws.at(off + i);
}

// y = M x for the n x n block at `off`
MS_HD static void ws_matvec(const Workspace& ws, size_t off, int n,
                            const float* x, float* y) {
  for (int i = 0; i < n; ++i) {
    float acc = ws.at(off + (size_t)i * n) * x[0];
    for (int k = 1; k < n; ++k) acc += ws.at(off + (size_t)i * n + k) * x[k];
    y[i] = acc;
  }
}

// x += Minv (b - (H + diag) x): one step of iterative refinement of
// x = Minv b, where Minv is the explicit inverse of (H + diag), with H the
// n x n block at `off_h`
MS_HD static void refine(const Workspace& ws, size_t off_inv, size_t off_h,
                         int n, const float* diag, float diag_c,
                         const float* b, float* x) {
  float r[MS_MAXD], dx[MS_MAXD];
  ws_matvec(ws, off_h, n, x, r);
  for (int i = 0; i < n; ++i)
    r[i] = b[i] - (r[i] + (diag ? diag[i] : diag_c) * x[i]);
  ws_matvec(ws, off_inv, n, r, dx);
  for (int i = 0; i < n; ++i) x[i] += dx[i];
}

// floats of workspace one env needs: Minv, Hinv and H (n x n each), the
// 3K x n contact rows and the n x R W, at the offsets megastep_env uses
static size_t ws_floats(const MegaTables& T) {
  const size_t n = T.ndof, R = 3 * T.K + T.n_lim;
  return 3 * n * n + 3 * (size_t)T.K * n + n * R;
}

// ---- the emit_links epilogue -------------------------------------------------

// Final link states of the post-integration state `st`, the TPU kernel's
// emit_links output (ops/megastep.py:994-1077; sim/dynamics.py:link_states
// semantics). The substep loop's FK is of the pre-step state, so this runs
// one more FK and a spatial-velocity pass about the world origin,
// vhat_b = vhat_parent + sum_d [a_w; p_b x a_w] v_d ([0; a_w] v_d for a
// slide), from the base's (w; v + p x w). Then per link: frame and
// centre-of-mass pose, and the velocity of the centre of mass. Writes
// MS_LINK_ROWS rows per link in LinkStates field order: frame_pos(3),
// frame_quat(4), com_pos(3), com_quat(4), lin_vel(3), ang_vel(3).
// Called, not inlined: inlined into the body, it changed how ptxas
// compiled the substep loop (144 registers instead of 142) and the variant
// took 630 ms against the default's 561 ms at B = 8192 on an H100; called,
// the loop keeps the default's 142 registers and its time, and the
// epilogue gets a frame of its own (14,224 bytes of stack in all).
MS_HD_CALL static void link_epilogue(const MegaTables& T, const float* st,
                                     float* links_out) {
  const int S = T.n_sph, NR = T.n_rev;
  const float* base_quat = st;
  const float* base_pos = st + 4;
  const float* base_ang = st + 7;
  const float* base_lin = st + 10;
  const float* q_sph = st + 13;
  const float* w_sph = st + 13 + 4 * S;
  const float* q_rev = st + 13 + 7 * S;
  const float* w_rev = st + 13 + 7 * S + NR;

  float qw[MS_MAXB][4], pw[MS_MAXB][3], Rw[MS_MAXB][9];
  fk_pass_q(T, q_sph, q_rev, base_quat, base_pos, qw, pw, Rw);

  float vhat[MS_MAXB][6];
  {
    float pxw[3];
    cross3(base_pos, base_ang, pxw);
    for (int i = 0; i < 3; ++i) {
      vhat[0][i] = base_ang[i];
      vhat[0][3 + i] = base_lin[i] + pxw[i];
    }
  }
  for (int t = 0; t < T.nb - 1; ++t) {
    const int b = T.topo[t], p = T.parent[b];
    const int d = T.dof_offset[b];
    float add[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < T.dof_count[b]; ++c) {
      const float vd = T.jtype[b] == 1 ? w_sph[3 * T.sph_index[b] + c]
                                       : w_rev[T.rev_index[b]];
      float aw[3];
      Rv(Rw[b], T.dof_axis[d + c], aw);
      if (T.dof_is_linear[d + c]) {
        for (int i = 0; i < 3; ++i) add[3 + i] += aw[i] * vd;
      } else {
        float pxa[3];
        cross3(pw[b], aw, pxa);
        for (int i = 0; i < 3; ++i) {
          add[i] += aw[i] * vd;
          add[3 + i] += pxa[i] * vd;
        }
      }
    }
    for (int r = 0; r < 6; ++r) vhat[b][r] = vhat[p][r] + add[r];
  }

  for (int l = 0; l < T.n_links; ++l) {
    const int b = T.link_body[l];
    float* o = links_out + MS_LINK_ROWS * l;
    float off[3], Rf[9], ioff[3], wxc[3];
    Rv(Rw[b], T.link_pos[l], off);
    for (int i = 0; i < 3; ++i) o[i] = pw[b][i] + off[i];          // frame_pos
    qmul(qw[b], T.link_quat[l], o + 3);                             // frame_quat
    q2R(o + 3, Rf);
    Rv(Rf, T.link_ipos[l], ioff);
    for (int i = 0; i < 3; ++i) o[7 + i] = o[i] + ioff[i];          // com_pos
    qmul(o + 3, T.link_iquat[l], o + 10);                           // com_quat
    cross3(vhat[b], o + 7, wxc);
    for (int i = 0; i < 3; ++i) {
      o[14 + i] = vhat[b][3 + i] + wxc[i];                          // lin_vel
      o[17 + i] = vhat[b][i];                                       // ang_vel
    }
  }
}

// ---- one env, `substeps` substeps ------------------------------------------

// EMIT_LINKS selects the variant at compile time, so the default variant
// (false) compiles to the same code as before the epilogue existed.
template <bool EMIT_LINKS>
MS_HD static void megastep_env(const MegaTables& T, const float* st_in,
                               const float* tgt_sph_in, const float* tgt_rev_in,
                               float* st_out, float* act_out, float* hist_out,
                               float* links_out, const Workspace& ws,
                               int substeps) {
  const int n = T.ndof, nb = T.nb, K = T.K, K3 = 3 * T.K;
  const int R = K3 + T.n_lim;
  const int S = T.n_sph, NR = T.n_rev;
  const int rows_state = 13 + 7 * S + 2 * NR;
  const int up = T.up;
  const int t1x = up == 0 ? 1 : 0;
  const int t2x = up == 2 ? 1 : 2;
  const float dt = T.dt;
  const size_t OFF_MINV = 0, OFF_HINV = (size_t)n * n, OFF_H = 2 * (size_t)n * n;
  const size_t OFF_ROWS = 3 * (size_t)n * n;
  const size_t OFF_W = OFF_ROWS + (size_t)K3 * n;

  float st[MS_MAXST], tgt_sph[MS_MAXS * 4], tgt_rev[MS_MAXR];
  for (int i = 0; i < rows_state; ++i) st[i] = st_in[i];
  for (int i = 0; i < 4 * S; ++i) tgt_sph[i] = tgt_sph_in[i];
  for (int i = 0; i < NR; ++i) tgt_rev[i] = tgt_rev_in[i];

  float pw[MS_MAXB][3], Rw[MS_MAXB][9];
  float v[MS_MAXD], col[MS_MAXD][6], waxis[MS_MAXD][3];
  float io[MS_MAXB][36];
  float mc[MS_MAXB], bcom[MS_MAXB][3], ccom[MS_MAXB][3], jc[MS_MAXB][9];
  float vhat[MS_MAXB][6], abias[MS_MAXB][6], fb[MS_MAXB][6];
  float f[MS_MAXD], kpe[MS_MAXD], a[MS_MAXD], dtau[MS_MAXD], tmp[MS_MAXD];
  float vstar[MS_MAXD], u[MS_MAXD];
  float dist[MS_MAXC], dwork[MS_MAXC], xs[MS_MAXC][3];
  float act_all[MS_MAXC];
  float sel_dist[MS_MAXK];
  float target[MS_MAXROWS], act_n[MS_MAXK], act_l[MS_MAXL];
  float rowsum[MS_MAXROWS], step[MS_MAXROWS], bvec[MS_MAXROWS];
  float lam[MS_MAXROWS], upd[MS_MAXROWS];

  for (int sub = 0; sub < substeps; ++sub) {
    const float* base_quat = st;
    const float* base_pos = st + 4;
    const float* base_ang = st + 7;
    const float* base_lin = st + 10;
    const float* q_sph = st + 13;
    const float* w_sph = st + 13 + 4 * S;
    const float* q_rev = st + 13 + 7 * S;
    const float* w_rev = st + 13 + 7 * S + NR;

    // ================= FK =================
    fk_pass(T, q_sph, q_rev, base_quat, base_pos, pw, Rw);

    // ============ generalized velocity ============
    {
      float wb[3], lb[3];
      Rtv(Rw[0], base_ang, wb);
      Rtv(Rw[0], base_lin, lb);
      for (int i = 0; i < 3; ++i) { v[i] = wb[i]; v[3 + i] = lb[i]; }
      for (int b = 1; b < nb; ++b) {
        const int d = T.dof_offset[b];
        if (T.jtype[b] == 1) {
          for (int c = 0; c < 3; ++c) v[d + c] = w_sph[3 * T.sph_index[b] + c];
        } else {
          v[d] = w_rev[T.rev_index[b]];
        }
      }
    }

    // H and C are taken in the frame of the base body (origin at the base,
    // axes along it), from a second FK pass that starts at the identity;
    // the TPU kernel takes them about the world origin with world axes.
    // The result does not depend on the frame, its fp32 rounding does: in
    // the base frame the base dofs' columns are exact unit vectors, as in
    // the body-frame CRBA of the plain version, and lever arms do not grow
    // with the distance walked. Contacts and integration keep the world FK.
    float Rb[MS_MAXB][9], pb[MS_MAXB][3];
    {
      const float q0[4] = {0.0f, 0.0f, 0.0f, 1.0f}, p0[3] = {0.0f, 0.0f, 0.0f};
      fk_pass(T, q_sph, q_rev, q0, p0, pb, Rb);
    }

    // ============ Jacobian columns (base frame) and world axes ============
    for (int d = 0; d < n; ++d) {
      const int b = T.dof_body[d];
      float ab[3];
      Rv(Rw[b], T.dof_axis[d], waxis[d]);
      Rv(Rb[b], T.dof_axis[d], ab);
      if (T.dof_is_linear[d]) {
        for (int i = 0; i < 3; ++i) { col[d][i] = 0.0f; col[d][3 + i] = ab[i]; }
      } else {
        float pxa[3];
        cross3(pb[b], ab, pxa);
        for (int i = 0; i < 3; ++i) { col[d][i] = ab[i]; col[d][3 + i] = pxa[i]; }
      }
    }

    // ============ per-body spatial inertia about the base (base frame) ====
    // I_O = [[I_cw + m cx cx^T, m cx], [-m cx, m 1]] (ang; lin)
    for (int b = 0; b < nb; ++b) {
      const float m = T.mass[b];
      float cw[3], ri[9], icw[9];
      Rv(Rb[b], T.com[b], cw);
      for (int i = 0; i < 3; ++i) cw[i] += pb[b][i];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          ri[3 * i + j] = Rb[b][3 * i] * T.inertia_c[b][j]
                          + Rb[b][3 * i + 1] * T.inertia_c[b][3 + j]
                          + Rb[b][3 * i + 2] * T.inertia_c[b][6 + j];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          icw[3 * i + j] = ri[3 * i] * Rb[b][3 * j] + ri[3 * i + 1] * Rb[b][3 * j + 1]
                           + ri[3 * i + 2] * Rb[b][3 * j + 2];
      for (int i = 0; i < 3; ++i) {
        bcom[b][i] = cw[i];
        ccom[b][i] = m * cw[i];
      }
      for (int k = 0; k < 9; ++k) jc[b][k] = icw[k];
      const float cx[9] = {0.0f, -cw[2], cw[1], cw[2], 0.0f, -cw[0], -cw[1], cw[0], 0.0f};
      float* blk = io[b];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const float cct = cx[3 * i] * cx[3 * j] + cx[3 * i + 1] * cx[3 * j + 1]
                            + cx[3 * i + 2] * cx[3 * j + 2];
          blk[6 * i + j] = icw[3 * i + j] + m * cct;
          blk[6 * i + 3 + j] = m * cx[3 * i + j];
          blk[6 * (3 + i) + j] = -m * cx[3 * i + j];
          blk[6 * (3 + i) + 3 + j] = i == j ? m : 0.0f;
        }
    }
    // Composite inertias of each subtree in centre-of-mass form: mass mc,
    // centre of mass ccom and rotational inertia jc about that centre.
    // The TPU kernel sums 6x6 inertias about one common origin instead;
    // there a light body far from the origin (a foot, ~1 m from the base)
    // contributes m |c|^2 ~ 1 to entries whose result is ~5e-3, and fp32
    // cancellation costs the ill-conditioned H (cond ~ 4e4) three digits.
    // Every lever arm below is taken from a subtree's own centre of mass.
    for (int b = 0; b < nb; ++b) mc[b] = T.mass[b];
    for (int t = nb - 2; t >= 0; --t) {
      const int b = T.topo[t], p = T.parent[b];
      mc[p] += mc[b];
      for (int i = 0; i < 3; ++i) ccom[p][i] += ccom[b][i];   // first moments
    }
    for (int b = 0; b < nb; ++b) {
      const float inv = 1.0f / fmaxf(mc[b], 1e-12f);
      float r[3];
      for (int i = 0; i < 3; ++i) {
        r[i] = bcom[b][i];
        ccom[b][i] *= inv;
        r[i] -= ccom[b][i];
      }
      add_parallel_axis(jc[b], T.mass[b], r);
    }
    for (int t = nb - 2; t >= 0; --t) {
      const int b = T.topo[t], p = T.parent[b];
      float r[3];
      for (int i = 0; i < 3; ++i) r[i] = ccom[b][i] - ccom[p][i];
      for (int k = 0; k < 9; ++k) jc[p][k] += jc[b][k];
      add_parallel_axis(jc[p], mc[b], r);
    }

    // ============ H on the static ancestor-pair sparsity ============
    // H[d, e] = col_d . IC_b(e) col_e, both columns about the centre of
    // mass of the subtree of body(e), where IC is block-diagonal
    for (size_t i = 0; i < (size_t)n * n; ++i) ws.at(OFF_MINV + i) = 0.0f;
    for (int e = 0; e < n; ++e) {
      const int be = T.dof_body[e];
      float ae[3], le[3], ya[3], yl[3];
      col_about(T, col, pb, ccom[be], e, ae, le);
      for (int i = 0; i < 3; ++i) {
        ya[i] = jc[be][3 * i] * ae[0] + jc[be][3 * i + 1] * ae[1] + jc[be][3 * i + 2] * ae[2];
        yl[i] = mc[be] * le[i];
      }
      for (int d = 0; d <= e; ++d) {
        if (!((T.anc[be] >> T.dof_body[d]) & 1u)) continue;
        float ad[3], ld[3];
        col_about(T, col, pb, ccom[be], d, ad, ld);
        const float h = ad[0] * ya[0] + ad[1] * ya[1] + ad[2] * ya[2]
                        + ld[0] * yl[0] + ld[1] * yl[1] + ld[2] * yl[2];
        ws.at(OFF_MINV + (size_t)d * n + e) = h;
        if (d != e) ws.at(OFF_MINV + (size_t)e * n + d) = h;
      }
    }
    for (size_t i = 0; i < (size_t)n * n; ++i) {
      ws.at(OFF_HINV + i) = ws.at(OFF_MINV + i);
      ws.at(OFF_H + i) = ws.at(OFF_MINV + i);
    }

    // ============ C: fixed-frame bias recursion ============
    // base spatial velocity in the base frame: the body-frame (omega, v)
    float grav[3];
    Rtv(Rw[0], T.gravity, grav);
    for (int i = 0; i < 6; ++i) {
      vhat[0][i] = v[i];
      abias[0][i] = 0.0f;
    }
    for (int t = 0; t < nb - 1; ++t) {
      const int b = T.topo[t], p = T.parent[b];
      const int d = T.dof_offset[b];
      float add[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = 0; c < T.dof_count[b]; ++c)
        for (int r = 0; r < 6; ++r) add[r] += col[d + c][r] * v[d + c];
      for (int r = 0; r < 6; ++r) vhat[b][r] = vhat[p][r] + add[r];
    }
    for (int t = 0; t < nb - 1; ++t) {
      const int b = T.topo[t], p = T.parent[b];
      float dvj[6], cr[6];
      for (int r = 0; r < 6; ++r) dvj[r] = vhat[b][r] - vhat[p][r];
      crm6(vhat[b], dvj, cr);
      for (int r = 0; r < 6; ++r) abias[b][r] = abias[p][r] + cr[r];
    }
    for (int b = 0; b < nb; ++b) {
      float av[6], iav[6], iv[6], cf[6];
      for (int r = 0; r < 6; ++r)
        av[r] = abias[b][r] - (r < 3 ? 0.0f : grav[r - 3]);
      for (int r = 0; r < 6; ++r) {
        float s1 = io[b][6 * r] * av[0], s2 = io[b][6 * r] * vhat[b][0];
        for (int c = 1; c < 6; ++c) {
          s1 += io[b][6 * r + c] * av[c];
          s2 += io[b][6 * r + c] * vhat[b][c];
        }
        iav[r] = s1;
        iv[r] = s2;
      }
      crf6(vhat[b], iv, cf);
      for (int r = 0; r < 6; ++r) fb[b][r] = iav[r] + cf[r];
    }
    for (int t = nb - 2; t >= 0; --t) {
      const int b = T.topo[t], p = T.parent[b];
      for (int r = 0; r < 6; ++r) fb[p][r] += fb[b][r];
    }

    // ============ SPD errors -> f = kpe - C ============
    for (int d = 0; d < n; ++d) {
      const float* fbd = fb[T.dof_body[d]];
      float c = col[d][0] * fbd[0];
      for (int r = 1; r < 6; ++r) c += col[d][r] * fbd[r];
      f[d] = -c;
      kpe[d] = 0.0f;
    }
    for (int mi = 0; mi < T.n_sph_motors; ++mi) {
      const int d0 = T.sph_motor_dof[mi], s = T.sph_motor_idx[mi];
      float ex[4], qp[4], qc[4], dq[4], ep[3];
      qexp_scaled(w_sph + 3 * s, dt, ex);
      qmul(q_sph + 4 * s, ex, qp);
      qnormalize(qp);
      qc[0] = -qp[0]; qc[1] = -qp[1]; qc[2] = -qp[2]; qc[3] = qp[3];
      qmul(qc, tgt_sph + 4 * s, dq);
      q_axis_angle(dq, ep);
      for (int c = 0; c < 3; ++c) {
        const float k = T.kp[d0 + c] * ep[c] - T.kd[d0 + c] * w_sph[3 * s + c];
        kpe[d0 + c] = k;
        f[d0 + c] += k;
      }
    }
    for (int mi = 0; mi < T.n_rev_motors; ++mi) {
      const int d0 = T.rev_motor_dof[mi], r = T.rev_motor_idx[mi];
      const float pred = q_rev[r] + w_rev[r] * dt;
      const float k = T.kp[d0] * (tgt_rev[r] - pred) - T.kd[d0] * w_rev[r];
      kpe[d0] = k;
      f[d0] += k;
    }

    // ============ inverses ============
    for (int i = 0; i < n; ++i) {
      ws.at(OFF_MINV + (size_t)i * n + i) += T.minv_diag[i];
      ws.at(OFF_HINV + (size_t)i * n + i) += T.eps;
    }
    gj_sweep(ws, OFF_MINV, n);
    gj_sweep(ws, OFF_HINV, n);
    // each solve through an explicit inverse gets one refinement step
    // against the kept H (the TPU kernel has none): the clamp correction
    // goes through cond(H) ~ 4e4, and this halves its fp32 error
    ws_matvec(ws, OFF_MINV, n, f, a);
    refine(ws, OFF_MINV, OFF_H, n, T.minv_diag, 0.0f, f, a);

    // torque-clamp correction
    for (int d = 0; d < n; ++d) dtau[d] = 0.0f;
    for (int mi = 0; mi < T.n_sph_motors; ++mi) {
      const int d0 = T.sph_motor_dof[mi];
      const float lim = T.sph_motor_lim[mi];
      float t3[3];
      for (int c = 0; c < 3; ++c) t3[c] = kpe[d0 + c] - T.kd_dt[d0 + c] * a[d0 + c];
      const float nrm = sqrtf(t3[0] * t3[0] + t3[1] * t3[1] + t3[2] * t3[2]);
      const float scale = nrm > lim ? lim / fmaxf(nrm, 1e-9f) : 1.0f;
      for (int c = 0; c < 3; ++c) dtau[d0 + c] = t3[c] * (scale - 1.0f);
    }
    for (int mi = 0; mi < T.n_rev_motors; ++mi) {
      const int d0 = T.rev_motor_dof[mi];
      const float lim = T.rev_motor_lim[mi];
      const float t1 = kpe[d0] - T.kd_dt[d0] * a[d0];
      dtau[d0] = fminf(fmaxf(t1, -lim), lim) - t1;
    }
    ws_matvec(ws, OFF_HINV, n, dtau, tmp);
    refine(ws, OFF_HINV, OFF_H, n, nullptr, T.eps, dtau, tmp);
    for (int d = 0; d < n; ++d) vstar[d] = v[d] + dt * (a[d] + tmp[d]);

    // ============ contacts: candidates + top-K ============
    // top-K by iterative argmin over the distances plus the static
    // tie-break (c+1)*1e-7, which makes each minimum unique (a level foot
    // puts four corners at one height). The tie-break only orders the
    // selection: flags, activity and Baumgarte targets use the true
    // distance, as sim/contact.py does (the TPU kernel feeds the shifted
    // distance to them, up to 4e-4 m/s off the reference targets).
    for (int c = 0; c < T.n_cand; ++c) {
      const int b = T.cand_body[c];
      float off[3], xc[3];
      Rv(Rw[b], T.cand_off[c], off);
      for (int i = 0; i < 3; ++i) xc[i] = pw[b][i] + off[i];
      // Jacobian anchor = surface point (centre - radius * up)
      for (int i = 0; i < 3; ++i) xs[c][i] = i == up ? xc[i] - T.cand_radius[c] : xc[i];
      dist[c] = xc[up] - T.cand_radius[c];
      dwork[c] = dist[c] + T.cand_tie[c];
      act_all[c] = dist[c] < 0.0f ? 1.0f : 0.0f;
    }
    for (int j = 0; j < K; ++j) {
      int sel = 0;
      for (int c = 1; c < T.n_cand; ++c)
        if (dwork[c] < dwork[sel]) sel = c;
      dwork[sel] = 1e30f;
      sel_dist[j] = dist[sel];
      const float* sx = xs[sel];
      const unsigned int anc = T.anc[T.cand_body[sel]];
      for (int d = 0; d < n; ++d) {
        float jr[3] = {0.0f, 0.0f, 0.0f};
        if ((anc >> T.dof_body[d]) & 1u) {
          if (T.dof_is_linear[d]) {
            for (int i = 0; i < 3; ++i) jr[i] = waxis[d][i];
          } else {
            const float* ap = pw[T.dof_body[d]];
            const float diff[3] = {sx[0] - ap[0], sx[1] - ap[1], sx[2] - ap[2]};
            cross3(waxis[d], diff, jr);
          }
        }
        ws.at(OFF_ROWS + (size_t)j * n + d) = jr[up];
        ws.at(OFF_ROWS + (size_t)(K + j) * n + d) = jr[t1x];
        ws.at(OFF_ROWS + (size_t)(2 * K + j) * n + d) = jr[t2x];
      }
    }

    // targets / activity
    for (int j = 0; j < K; ++j) {
      const float pen = fmaxf(-sel_dist[j] - T.slop, 0.0f);
      target[j] = T.erp_dt * pen;
      act_n[j] = sel_dist[j] < 0.0f ? 1.0f : 0.0f;
      target[K + j] = 0.0f;
      target[2 * K + j] = 0.0f;
    }
    for (int li = 0; li < T.n_lim; ++li) {
      const float viol = T.lim_sign[li] * (T.lim_val[li] - q_rev[T.lim_rev[li]]);
      act_l[li] = viol > 0.0f ? 1.0f : 0.0f;
      target[K3 + li] = T.limit_erp_dt * fmaxf(viol, 0.0f);
    }

    // ============ W = Hinv J^T ; rowsum(|A|) ; projected Jacobi ============
    for (int k = 0; k < n; ++k) {
      for (int jj = 0; jj < K3; ++jj) {
        float acc = ws.at(OFF_HINV + (size_t)k * n) * ws.at(OFF_ROWS + (size_t)jj * n);
        for (int kk = 1; kk < n; ++kk)
          acc += ws.at(OFF_HINV + (size_t)k * n + kk) * ws.at(OFF_ROWS + (size_t)jj * n + kk);
        ws.at(OFF_W + (size_t)k * R + jj) = acc;
      }
      for (int li = 0; li < T.n_lim; ++li)
        ws.at(OFF_W + (size_t)k * R + K3 + li) =
            T.lim_sign[li] * ws.at(OFF_HINV + (size_t)k * n + T.lim_dof[li]);
    }
    // contact block of A = J W on the upper triangle, mirrored into the
    // row sums (A is symmetric); it steers the step only
    for (int i = 0; i < R; ++i) rowsum[i] = 0.0f;
    for (int i = 0; i < K3; ++i) {
      for (int j = i; j < K3; ++j) {
        float acc = ws.at(OFF_ROWS + (size_t)i * n) * ws.at(OFF_W + j);
        for (int kk = 1; kk < n; ++kk)
          acc += ws.at(OFF_ROWS + (size_t)i * n + kk) * ws.at(OFF_W + (size_t)kk * R + j);
        const float aa = fabsf(acc);
        rowsum[i] += aa;
        if (j != i) rowsum[j] += aa;
      }
    }
    for (int li = 0; li < T.n_lim; ++li) {
      const size_t wrow = OFF_W + (size_t)T.lim_dof[li] * R;
      // A[i, 3K+li] = sign * W[dof_li, i] (Hinv symmetric)
      for (int i = 0; i < K3; ++i) rowsum[i] += fabsf(ws.at(wrow + i));
      // limit row: A[3K+li, :] = sign * W[dof_li, :]
      float s = 0.0f;
      for (int j = 0; j < R; ++j) s += fabsf(ws.at(wrow + j));
      rowsum[K3 + li] = s;
    }
    for (int i = 0; i < R; ++i)
      step[i] = T.relaxation / fmaxf(rowsum[i] + T.cfm, 1e-9f);

    for (int i = 0; i < K3; ++i) {
      float acc = ws.at(OFF_ROWS + (size_t)i * n) * vstar[0];
      for (int kk = 1; kk < n; ++kk) acc += ws.at(OFF_ROWS + (size_t)i * n + kk) * vstar[kk];
      bvec[i] = acc - target[i];
    }
    for (int li = 0; li < T.n_lim; ++li)
      bvec[K3 + li] = T.lim_sign[li] * vstar[T.lim_dof[li]] - target[K3 + li];

    for (int i = 0; i < R; ++i) lam[i] = 0.0f;
    for (int it = 0; it < T.iterations; ++it) {
      for (int k = 0; k < n; ++k) {
        float acc = ws.at(OFF_W + (size_t)k * R) * lam[0];
        for (int j = 1; j < R; ++j) acc += ws.at(OFF_W + (size_t)k * R + j) * lam[j];
        u[k] = acc;
      }
      for (int i = 0; i < K3; ++i) {
        float acc = ws.at(OFF_ROWS + (size_t)i * n) * u[0];
        for (int kk = 1; kk < n; ++kk) acc += ws.at(OFF_ROWS + (size_t)i * n + kk) * u[kk];
        upd[i] = lam[i] - step[i] * (acc + bvec[i]);
      }
      for (int li = 0; li < T.n_lim; ++li) {
        const int i = K3 + li;
        upd[i] = lam[i] - step[i] * (T.lim_sign[li] * u[T.lim_dof[li]] + bvec[i]);
      }
      for (int j = 0; j < K; ++j) {
        const float ln = fmaxf(upd[j], 0.0f) * act_n[j];
        const float bound = T.mu * ln;
        lam[j] = ln;
        lam[K + j] = fminf(fmaxf(upd[K + j], -bound), bound) * act_n[j];
        lam[2 * K + j] = fminf(fmaxf(upd[2 * K + j], -bound), bound) * act_n[j];
      }
      for (int li = 0; li < T.n_lim; ++li)
        lam[K3 + li] = fmaxf(upd[K3 + li], 0.0f) * act_l[li];
    }
    // v_new = clip(v* + W lam, +-100), kept in `u`
    for (int k = 0; k < n; ++k) {
      float acc = ws.at(OFF_W + (size_t)k * R) * lam[0];
      for (int j = 1; j < R; ++j) acc += ws.at(OFF_W + (size_t)k * R + j) * lam[j];
      u[k] = fminf(fmaxf(vstar[k] + acc, -100.0f), 100.0f);
    }

    // ============ integrate (dynamics.advance semantics) ============
    {
      float dpos[3], ex[4], nq[4], R0n[9], na[3], nl[3];
      Rv(Rw[0], u + 3, dpos);
      qexp_scaled(u, dt, ex);
      qmul(base_quat, ex, nq);
      qnormalize(nq);
      q2R(nq, R0n);
      Rv(R0n, u, na);
      Rv(R0n, u + 3, nl);
      float new_pos[3];
      for (int i = 0; i < 3; ++i) new_pos[i] = base_pos[i] + dt * dpos[i];
      float qs_new[MS_MAXS * 4];
      for (int s = 0; s < S; ++s) {
        const int d = T.dof_offset[T.sph_body[s]];
        float exs[4];
        qexp_scaled(u + d, dt, exs);
        qmul(q_sph + 4 * s, exs, qs_new + 4 * s);
        qnormalize(qs_new + 4 * s);
      }
      float qr_new[MS_MAXR], wr_new[MS_MAXR];
      for (int r = 0; r < NR; ++r) {
        const int d = T.dof_offset[T.rev_body[r]];
        wr_new[r] = u[d];
        float q = q_rev[r] + dt * u[d];
        if (T.rev_has_limit[r]) q = fminf(fmaxf(q, T.rev_lo[r]), T.rev_hi[r]);
        qr_new[r] = q;
      }
      // write the new state in place (all reads of the old state are done)
      for (int i = 0; i < 4; ++i) st[i] = nq[i];
      for (int i = 0; i < 3; ++i) {
        st[4 + i] = new_pos[i];
        st[7 + i] = na[i];
        st[10 + i] = nl[i];
        hist_out[3 * sub + i] = new_pos[i];
      }
      for (int s = 0; s < S; ++s) {
        const int d = T.dof_offset[T.sph_body[s]];
        for (int c = 0; c < 4; ++c) st[13 + 4 * s + c] = qs_new[4 * s + c];
        for (int c = 0; c < 3; ++c) st[13 + 4 * S + 3 * s + c] = u[d + c];
      }
      for (int r = 0; r < NR; ++r) {
        st[13 + 7 * S + r] = qr_new[r];
        st[13 + 7 * S + NR + r] = wr_new[r];
      }
    }
  }
  for (int i = 0; i < rows_state; ++i) st_out[i] = st[i];
  for (int c = 0; c < T.n_cand; ++c) act_out[c] = act_all[c];
  if constexpr (EMIT_LINKS) link_epilogue(T, st, links_out);
}

// ---- entry points -----------------------------------------------------------

#ifdef __CUDACC__

template <bool EMIT_LINKS>
__global__ void megastep_kernel(const MegaTables* __restrict__ tables,
                                const float* __restrict__ st,
                                const float* __restrict__ tgt_sph,
                                const float* __restrict__ tgt_rev,
                                float* __restrict__ st_out,
                                float* __restrict__ act_out,
                                float* __restrict__ hist_out,
                                float* __restrict__ links_out,
                                float* __restrict__ ws, int B, int substeps) {
  __shared__ MegaTables T;
  {
    const int* src = reinterpret_cast<const int*>(tables);
    int* dst = reinterpret_cast<int*>(&T);
    const int words = (int)(sizeof(MegaTables) / sizeof(int));
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  const int rs = 13 + 7 * T.n_sph + 2 * T.n_rev;
  Workspace w{ws, (size_t)B, (size_t)env};
  float* links = nullptr;
  if constexpr (EMIT_LINKS) links = links_out + (size_t)env * MS_LINK_ROWS * T.n_links;
  megastep_env<EMIT_LINKS>(
      T, st + (size_t)env * rs, tgt_sph + (size_t)env * 4 * T.n_sph,
      tgt_rev + (size_t)env * T.n_rev, st_out + (size_t)env * rs,
      act_out + (size_t)env * T.n_cand, hist_out + (size_t)env * 3 * substeps,
      links, w, substeps);
}

// Launch on `stream`: the emit_links variant when links_out is not null,
// else the default one. Returns cudaGetLastError() (0 = launched).
extern "C" int pfpn_megastep_launch(const void* tables, const float* st,
                                    const float* tgt_sph, const float* tgt_rev,
                                    float* st_out, float* act_out,
                                    float* hist_out, float* links_out,
                                    float* ws, int B, int substeps,
                                    void* stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  if (links_out) {
    megastep_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const MegaTables*)tables, st, tgt_sph, tgt_rev, st_out, act_out,
        hist_out, links_out, ws, B, substeps);
  } else {
    megastep_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const MegaTables*)tables, st, tgt_sph, tgt_rev, st_out, act_out,
        hist_out, nullptr, ws, B, substeps);
  }
  return (int)cudaGetLastError();
}

#else

// Host build of the same per-env body (g++ -x c++), for the CPU tests; the
// emit_links variant when links_out is not null.
extern "C" int pfpn_megastep_host(const void* tables, const float* st,
                                  const float* tgt_sph, const float* tgt_rev,
                                  float* st_out, float* act_out,
                                  float* hist_out, float* links_out, float* ws,
                                  int B, int substeps) {
  const MegaTables& T = *(const MegaTables*)tables;
  const int rs = 13 + 7 * T.n_sph + 2 * T.n_rev;
  for (int env = 0; env < B; ++env) {
    Workspace w{ws, (size_t)B, (size_t)env};
    const float* s = st + (size_t)env * rs;
    const float* ts = tgt_sph + (size_t)env * 4 * T.n_sph;
    const float* tr = tgt_rev + (size_t)env * T.n_rev;
    float* so = st_out + (size_t)env * rs;
    float* ao = act_out + (size_t)env * T.n_cand;
    float* ho = hist_out + (size_t)env * 3 * substeps;
    if (links_out)
      megastep_env<true>(T, s, ts, tr, so, ao, ho,
                         links_out + (size_t)env * MS_LINK_ROWS * T.n_links, w,
                         substeps);
    else
      megastep_env<false>(T, s, ts, tr, so, ao, ho, nullptr, w, substeps);
  }
  return 0;
}

#endif

extern "C" int pfpn_megastep_tables_bytes(void) { return (int)sizeof(MegaTables); }

extern "C" long long pfpn_megastep_ws_floats(const void* tables) {
  return (long long)ws_floats(*(const MegaTables*)tables);
}
