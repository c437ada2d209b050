// The 30 Hz control step ("megastep") for Hopper: FK, mass matrix, bias
// forces, Stable-PD, ground contacts and integration for frame_skip
// substeps of a batch of environments, in one launch.
//
// Replaces the TPU kernel pfpn_tpu/ops/megastep.py:_make_kernel (inner
// `kernel`, :406), launched by megastep_pallas (:1157), in both of its
// variants: the default one, and emit_links (:994-1077), which also writes
// the final link states. Per substep it runs the TPU kernel's stages in its
// order: FK; velocity rows and Jacobian columns; per-body inertias; H over
// the static ancestor-pair sparsity; C by the fixed-frame bias recursion;
// SPD errors -> f; two unpivoted Gauss-Jordan inverses, of
// (H + diag(kd dt) + eps) and (H + eps), with the torque-clamp correction;
// candidate points and top-K by iterative argmin with the static tie-break
// (c+1)*1e-7; W = Hinv J^T, Gershgorin row sums and projected-Jacobi sweeps
// in W-form; integration with exp-map quaternions, the +-100 cap and the
// revolute clamps. Where it departs from the TPU kernel it is for fp32
// accuracy against the plain version, and each place says so: H and C in
// the base frame, H from centre-of-mass composites, one refinement step per
// inverse solve, true (untied) distances for flags and targets. atan2f
// replaces the TPU kernel's atan polynomial.
//
// Bound on this card. The function moves ~1 KB per env (state, targets in;
// state, flags, base history out) but does ~7.7 MFLOP of fp32 arithmetic
// per env per control step for the humanoid (ndof 34, K 16, 56 rows), as
// ops/megastep.py:megastep_flops counts the least work (a Cholesky factor
// and one solve for each inverse; the two Gauss-Jordan sweeps below do
// more). At the H100's 67 TFLOP/s fp32 outside the tensor cores that is
// ~0.95 ms for B = 8192: bound by operations, not bytes.
//
// Design. One thread block per environment (128 threads by default, the
// fastest at B = 8192 of 64, 128 and 256; chip_smoke.py phase 5 times all
// three), its whole workspace in shared memory, so nothing but the inputs
// and the outputs touches device memory. (One env per thread would run
// every loop of the training batch, B = 8, in series in one partly filled
// warp, fill a twentieth of the card's thread slots at B = 8192, and keep
// the matrices in device memory: ~1.6 MB of L2 traffic per env per
// substep.) The static tables
// (MegaTables, ~6 KB) and the per-env arrays (MsSmall: state, targets,
// per-body frames, inertias, composites and bias terms, per-dof and
// per-candidate vectors, ~14 KB at their capacities) are static shared
// memory at constant addresses; the matrices sized by the tables (the two
// inverses and H, 3 n^2; the 3K x n contact rows; the n x R W; ~28 KB for
// the humanoid) are dynamic shared memory, the rows and W with odd leading
// dimensions so that one thread per row reads distinct banks. Every stage
// is split into phases separated by BL_SYNC() (__syncthreads), about 90 a
// substep: FK level by level of the tree, world and base frames together;
// one phase for everything per dof, per body, per candidate and per motor;
// the composite inertias bottom-up beside the velocity recursion
// top-down, then the bias forces bottom-up beside H (one thread per
// element of its upper triangle) and the contact rows (one per (contact,
// dof)), one tree level a phase; both inverses in the same barrier phases
// (block_linalg.cuh:gj_sweep_pair, one barrier per pivot); W one thread per
// (dof, contact) triple; the refinement solves one thread per row; the
// upper triangle of |A| one thread per element, in the space of Minv and H,
// dead by then; row sums one thread per row; each Jacobi sweep two phases,
// one thread per dof for u = W lam and one per contact (its three rows) or
// limit row for the projected update; integration one thread per joint,
// into the other copy of the state. Top-K is 16 warp-wide argmin
// reductions over the candidates by the block's first warp, comparing
// (keyed distance, index) lexicographically, which picks what the serial
// `<` scan picks (the lower index among equal keys), whatever the order of
// the reduction. Every output element is computed by one thread, with the
// arithmetic and summation order of the one-thread-per-env version
// (dot_in_order, dot3_in_order), so the thread count changes no result.
// What bounds it now (tools/megastep_phases.py): the Gauss-Jordan sweeps
// take ~43% of a block's cycles and the Jacobi sweeps ~22%, chains of
// shared-memory loads and dependent arithmetic that a single warp per
// scheduler (B = 8) cannot overlap; at B = 8192 four blocks share an SM
// (128 registers a thread, ~49 KB of shared memory a block).
//
// Built without --use_fast_math: approximate sqrt, division and exp shift
// knife-edge contacts.
//
// The same block body compiles as plain C++ (g++ -x c++) into a host
// library, run by `threads` host threads with a std::barrier as
// BL_SYNC(), so the CPU tests hold this source's arithmetic against the
// PyTorch plain version without a card, and a missing barrier shows as a
// difference between one thread and several.

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MS_HD __host__ __device__ __forceinline__
#else
#define MS_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define BL_SYNC() __syncthreads()
#elif !defined(__CUDACC__)
#include <barrier>
#include <thread>
#include <vector>
// the host build's block barrier, one per host "block" of threads
static thread_local std::barrier<>* ms_host_barrier = nullptr;
static inline void ms_host_sync() { ms_host_barrier->arrive_and_wait(); }
#define BL_SYNC() ms_host_sync()
#else
#define BL_SYNC() ((void)0)
#endif
#include "block_linalg.cuh"

#define MS_MAXB 16     // bodies
#define MS_MAXD 40     // dofs
#define MS_MAXC 48     // contact candidates (two per lane of one warp)
#define MS_MAXK 16     // selected contacts (K)
#define MS_MAXL 8      // joint-limit rows
#define MS_MAXS 12     // spherical joints
#define MS_MAXR 8      // revolute joints
#define MS_MAXLK 16    // URDF links (the emit_links output)
#define MS_LINK_ROWS 20
#define MS_THREADS 128       // threads per block (one block per env)
#define MS_MAX_THREADS 256   // the most a launch may ask for

// Static tables; ops/megastep.py mirrors this layout with ctypes (all
// fields are 4 bytes wide, so there is no padding).
struct MegaTables {
  int ndof, nb, n_sph, n_rev, n_cand, K, n_lim, frame_skip, up, iterations;
  int n_sph_motors, n_rev_motors, n_levels;
  int order[MS_MAXB];           // the root, then the other bodies by level
  int level_off[MS_MAXB + 1];   // level l: order[level_off[l] .. level_off[l+1])
  int child_off[MS_MAXB + 1];   // children of b: child[child_off[b] ..
  int child[MS_MAXB];           //   child_off[b+1]), last in `order` first
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

MS_HD void qmul(const float* a, const float* b, float* o) {
  const float x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
  const float x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
  o[0] = w2 * x1 + x2 * w1 - y2 * z1 + z2 * y1;
  o[1] = w2 * y1 + x2 * z1 + y2 * w1 - z2 * x1;
  o[2] = w2 * z1 - x2 * y1 + y2 * x1 + z2 * w1;
  o[3] = w2 * w1 - x2 * x1 - y2 * y1 - z2 * z1;
}

MS_HD void qnormalize(float* q) {
  const float nn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float inv = 1.0f / fmaxf(nn, 1e-8f);
  q[0] *= inv; q[1] *= inv; q[2] *= inv; q[3] *= inv;
}

// row-major 3x3 rotation of a unit quaternion
MS_HD void q2R(const float* q, float* R) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}

MS_HD void Rv(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

// row i of R^T v
MS_HD float Rtv_i(const float* R, const float* v, int i) {
  return R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
}

MS_HD void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// exp map of (w * scale) as a quaternion
MS_HD void qexp_scaled(const float* w, float scale, float* q) {
  const float v0 = w[0] * scale, v1 = w[1] * scale, v2 = w[2] * scale;
  const float ang = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
  const float half = 0.5f * ang;
  const float k = ang > 1e-6f ? sinf(half) / fmaxf(ang, 1e-8f) : 0.5f;
  q[0] = v0 * k; q[1] = v1 * k; q[2] = v2 * k; q[3] = cosf(half);
}

// shortest-path axis*angle of a quaternion
MS_HD void q_axis_angle(const float* q, float* e) {
  const float sgn = q[3] < 0.0f ? -1.0f : 1.0f;
  const float x = q[0] * sgn, y = q[1] * sgn, z = q[2] * sgn, w = q[3] * sgn;
  const float s = sqrtf(x * x + y * y + z * z);
  const float wc = fminf(fmaxf(w, 0.0f), 1.0f);
  const float ang = 2.0f * atan2f(s, wc);
  const float k = s > 1e-8f ? ang / fmaxf(s, 1e-8f) : 0.0f;
  e[0] = x * k; e[1] = y * k; e[2] = z * k;
}

// spatial cross products on (ang; lin) 6-vectors
MS_HD void crm6(const float* v, const float* u, float* o) {
  float a[3], b[3];
  cross3(v, u, o);
  cross3(v, u + 3, a);
  cross3(v + 3, u, b);
  for (int i = 0; i < 3; ++i) o[3 + i] = a[i] + b[i];
}

MS_HD void crf6(const float* v, const float* f, float* o) {
  float a[3], b[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  for (int i = 0; i < 3; ++i) o[i] = a[i] + b[i];
  cross3(v, f + 3, o + 3);
}

// J += m (|r|^2 1 - r r^T): the parallel-axis term of a mass m at r
MS_HD void add_parallel_axis(float* J, float m, const float* r) {
  const float rr = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      J[3 * i + j] += m * ((i == j ? rr : 0.0f) - r[i] * r[j]);
}

// motion column of dof d about the point o: (a; (p - o) x a) for a
// rotation about the axis a through the body origin p, (0; a) for a slide
MS_HD void col_about(const MegaTables& T, const float (*col)[6],
                     const float (*pb)[3], const float* o, int d, float* a,
                     float* l) {
  if (T.dof_is_linear[d]) {
    for (int i = 0; i < 3; ++i) { a[i] = 0.0f; l[i] = col[d][3 + i]; }
    return;
  }
  const float* p = pb[T.dof_body[d]];
  const float r[3] = {p[0] - o[0], p[1] - o[1], p[2] - o[2]};
  for (int i = 0; i < 3; ++i) a[i] = col[d][i];
  cross3(r, a, l);
}

// Three dot products against one vector, s_i = sum_k a_i[k] x[k], each
// accumulated in k order as dot_in_order does; the loads of each batch of
// 4 terms are issued before its arithmetic.
MS_HD void dot3_in_order(const float* a0, const float* a1, const float* a2,
                         const float* x, int n, float& s0, float& s1, float& s2) {
  s0 = a0[0] * x[0];
  s1 = a1[0] * x[0];
  s2 = a2[0] * x[0];
  int k = 1;
  for (; k + 4 <= n; k += 4) {
    float xv[4], p0[4], p1[4], p2[4];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int c = 0; c < 4; ++c) {
      xv[c] = x[k + c];
      p0[c] = a0[k + c];
      p1[c] = a1[k + c];
      p2[c] = a2[k + c];
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int c = 0; c < 4; ++c) {
      s0 += p0[c] * xv[c];
      s1 += p1[c] * xv[c];
      s2 += p2[c] * xv[c];
    }
  }
  for (; k < n; ++k) {
    s0 += a0[k] * x[k];
    s1 += a1[k] * x[k];
    s2 += a2[k] * x[k];
  }
}

// The first item of a list that thread `tid` of `nt` takes, when the
// phase's lists are dealt out as one sequence and this list starts at
// position `base` of it (so several short lists share the threads evenly).
MS_HD int first_item(int tid, int nt, int base) {
  const int r = (tid - base) % nt;
  return r < 0 ? r + nt : r;
}

// ---- the block's shared memory ----------------------------------------------

#define MS_MAXST (13 + 7 * MS_MAXS + 2 * MS_MAXR)
#define MS_MAXROWS (3 * MS_MAXK + MS_MAXL)

// The block's per-env arrays, at their capacities, in static shared memory:
// their addresses are constants, not registers.
struct MsSmall {
  float st[2][MS_MAXST];            // the state, double-buffered
  float tgt_sph[4 * MS_MAXS], tgt_rev[MS_MAXR];
  float qw[MS_MAXB][4], pw[MS_MAXB][3], Rw[MS_MAXB][9];   // world FK
  float qb[MS_MAXB][4], pb[MS_MAXB][3], Rb[MS_MAXB][9];   // base-frame FK
  float io[MS_MAXB][36], mc[MS_MAXB], bcom[MS_MAXB][3], fm[MS_MAXB][3];
  float ccom[MS_MAXB][3], jc[MS_MAXB][9];
  float vhat[MS_MAXB][6], abias[MS_MAXB][6], fb[MS_MAXB][6];
  float v[MS_MAXD], col[MS_MAXD][6], waxis[MS_MAXD][3];
  float f[MS_MAXD], kpe[MS_MAXD], a[MS_MAXD], dtau[MS_MAXD], tmp[MS_MAXD];
  float vstar[MS_MAXD], u[MS_MAXD], r[MS_MAXD];
  float dist[MS_MAXC], dwork[MS_MAXC], xs[MS_MAXC][3], act_all[MS_MAXC];
  int sel[MS_MAXK];
  float sel_dist[MS_MAXK];
  float target[MS_MAXROWS], act[MS_MAXROWS], step[MS_MAXROWS];
  float bvec[MS_MAXROWS], lam[MS_MAXROWS];
  float gj[8 * MS_MAXD];            // gj_sweep_pair's row and column copies
};

// The matrices, sized by the tables, in the block's dynamic shared memory
// (offsets in floats). Hinv and Minv are stacked (gj_sweep_pair); the upper
// triangle of |A| takes the space of Minv and H once the refinement steps
// are done. The contact rows and W have odd leading dimensions (ldr, ldw),
// so that threads reading one row each hit distinct banks (a stride of 56
// floats put W's rows in 4 of the 32 banks).
struct MsLayout {
  int hinv, minv, h, a, rows, w, ldr, ldw, total;
};

MS_HD MsLayout ms_layout(const MegaTables& T) {
  const int n = T.ndof, K3 = 3 * T.K, R = K3 + T.n_lim;
  MsLayout s;
  s.ldr = n | 1;
  s.ldw = R | 1;
  s.hinv = 0;
  s.minv = s.a = n * n;
  s.h = 2 * n * n;
  const int mh = 2 * n * n > K3 * K3 ? 2 * n * n : K3 * K3;
  s.rows = n * n + mh;
  s.w = s.rows + K3 * s.ldr;
  s.total = s.w + n * s.ldw;
  return s;
}

// ---- FK ----------------------------------------------------------------------

// body b's quaternion, position and rotation from its parent's (the root's
// from the base pose q0, p0)
MS_HD void fk_body(const MegaTables& T, const float* q_sph, const float* q_rev,
                   const float* q0, const float* p0, int b, float (*q)[4],
                   float (*p)[3], float (*R)[9]) {
  if (b == 0) {
    for (int i = 0; i < 4; ++i) q[0][i] = q0[i];
    for (int i = 0; i < 3; ++i) p[0][i] = p0[i];
    q2R(q[0], R[0]);
    return;
  }
  const int par = T.parent[b];
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

// ---- the emit_links epilogue -------------------------------------------------

// Final link states of the post-integration state `st`, the TPU kernel's
// emit_links output (ops/megastep.py:994-1077; sim/dynamics.py:link_states
// semantics). The substep loop's FK is of the pre-step state, so this runs
// one more FK and a spatial-velocity pass about the world origin,
// vhat_b = vhat_parent + sum_d [a_w; p_b x a_w] v_d ([0; a_w] v_d for a
// slide), from the base's (w; v + p x w), level by level (the velocities of
// level l beside the FK of level l+1). Then one thread per link: frame and
// centre-of-mass pose, and the velocity of the centre of mass. Writes
// MS_LINK_ROWS rows per link in LinkStates field order: frame_pos(3),
// frame_quat(4), com_pos(3), com_quat(4), lin_vel(3), ang_vel(3).
MS_HD void link_epilogue(const MegaTables& T, const float* st, float (*qw)[4],
                         float (*pw)[3], float (*Rw)[9], float (*vhat)[6],
                         float* links_out, int tid, int nt) {
  const int S = T.n_sph, NR = T.n_rev;
  const float* base_quat = st;
  const float* base_pos = st + 4;
  const float* base_ang = st + 7;
  const float* base_lin = st + 10;
  const float* q_sph = st + 13;
  const float* w_sph = st + 13 + 4 * S;
  const float* q_rev = st + 13 + 7 * S;
  const float* w_rev = st + 13 + 7 * S + NR;

  for (int lev = 0; lev <= T.n_levels; ++lev) {
    int base = 0;
    if (lev < T.n_levels) {
      const int lo = T.level_off[lev], cnt = T.level_off[lev + 1] - lo;
      for (int i = first_item(tid, nt, base); i < cnt; i += nt)
        fk_body(T, q_sph, q_rev, base_quat, base_pos, T.order[lo + i], qw, pw, Rw);
      base += cnt;
    }
    if (lev >= 1) {
      const int lo = T.level_off[lev - 1], cnt = T.level_off[lev] - lo;
      for (int i = first_item(tid, nt, base); i < cnt; i += nt) {
        const int b = T.order[lo + i];
        if (b == 0) {
          float pxw[3];
          cross3(base_pos, base_ang, pxw);
          for (int k = 0; k < 3; ++k) {
            vhat[0][k] = base_ang[k];
            vhat[0][3 + k] = base_lin[k] + pxw[k];
          }
          continue;
        }
        const int p = T.parent[b], d = T.dof_offset[b];
        float add[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int c = 0; c < T.dof_count[b]; ++c) {
          const float vd = T.jtype[b] == 1 ? w_sph[3 * T.sph_index[b] + c]
                                           : w_rev[T.rev_index[b]];
          float aw[3];
          Rv(Rw[b], T.dof_axis[d + c], aw);
          if (T.dof_is_linear[d + c]) {
            for (int k = 0; k < 3; ++k) add[3 + k] += aw[k] * vd;
          } else {
            float pxa[3];
            cross3(pw[b], aw, pxa);
            for (int k = 0; k < 3; ++k) {
              add[k] += aw[k] * vd;
              add[3 + k] += pxa[k] * vd;
            }
          }
        }
        for (int r = 0; r < 6; ++r) vhat[b][r] = vhat[p][r] + add[r];
      }
    }
    BL_SYNC();
  }

  for (int l = tid; l < T.n_links; l += nt) {
    const int b = T.link_body[l];
    float* o = links_out + MS_LINK_ROWS * l;
    float fp[3], fq[4], cp[3], cq[4], off[3], Rf[9], ioff[3], wxc[3];
    Rv(Rw[b], T.link_pos[l], off);
    for (int i = 0; i < 3; ++i) fp[i] = pw[b][i] + off[i];
    qmul(qw[b], T.link_quat[l], fq);
    q2R(fq, Rf);
    Rv(Rf, T.link_ipos[l], ioff);
    for (int i = 0; i < 3; ++i) cp[i] = fp[i] + ioff[i];
    qmul(fq, T.link_iquat[l], cq);
    cross3(vhat[b], cp, wxc);
    for (int i = 0; i < 3; ++i) {
      o[i] = fp[i];                                  // frame_pos
      o[7 + i] = cp[i];                              // com_pos
      o[14 + i] = vhat[b][3 + i] + wxc[i];           // lin_vel
      o[17 + i] = vhat[b][i];                        // ang_vel
    }
    for (int i = 0; i < 4; ++i) {
      o[3 + i] = fq[i];                              // frame_quat
      o[10 + i] = cq[i];                             // com_quat
    }
  }
}

// ---- one env, `substeps` substeps, by thread tid of nt --------------------------

// EMIT_LINKS selects the variant at compile time. `sm` holds the block's
// per-env arrays and `sh` its matrices (ms_layout(T).total floats).
template <bool EMIT_LINKS>
MS_HD void megastep_block(const MegaTables& T, const float* st_in,
                          const float* tgt_sph_in, const float* tgt_rev_in,
                          float* st_out, float* act_out, float* hist_out,
                          float* links_out, MsSmall& sm, float* sh, int substeps,
                          int tid, int nt) {
  const int n = T.ndof, nb = T.nb, nc = T.n_cand, K = T.K, K3 = 3 * T.K;
  const int NL = T.n_lim, R = K3 + NL;
  const int S = T.n_sph, NR = T.n_rev;
  const int rs = 13 + 7 * S + 2 * NR;
  const int n_sm = T.n_sph_motors, n_m = T.n_sph_motors + T.n_rev_motors;
  const int levels = T.n_levels;
  const int up = T.up;
  const int t1x = up == 0 ? 1 : 0;
  const int t2x = up == 2 ? 1 : 2;
  const float dt = T.dt;
  const MsLayout L = ms_layout(T);
  const int ldr = L.ldr, ldw = L.ldw;

  float* Hinv = sh + L.hinv;
  float* Minv = sh + L.minv;
  float* H = sh + L.h;
  float* A = sh + L.a;
  float* rows = sh + L.rows;
  float* W = sh + L.w;
  float (*stbuf)[MS_MAXST] = sm.st;
  float* tgt_sph = sm.tgt_sph;
  float* tgt_rev = sm.tgt_rev;
  float (*qw)[4] = sm.qw;
  float (*pw)[3] = sm.pw;
  float (*Rw)[9] = sm.Rw;
  float (*qb)[4] = sm.qb;
  float (*pb)[3] = sm.pb;
  float (*Rb)[9] = sm.Rb;
  float (*io)[36] = sm.io;
  float* mc = sm.mc;
  float (*bcom)[3] = sm.bcom;
  float (*fm)[3] = sm.fm;
  float (*ccom)[3] = sm.ccom;
  float (*jc)[9] = sm.jc;
  float (*vhat)[6] = sm.vhat;
  float (*abias)[6] = sm.abias;
  float (*fb)[6] = sm.fb;
  float* v = sm.v;
  float (*col)[6] = sm.col;
  float (*waxis)[3] = sm.waxis;
  float* f = sm.f;
  float* kpe = sm.kpe;
  float* a = sm.a;
  float* dtau = sm.dtau;
  float* tmp = sm.tmp;
  float* vstar = sm.vstar;
  float* u = sm.u;
  float* r = sm.r;
  float* dist = sm.dist;
  float* dwork = sm.dwork;
  float (*xs)[3] = sm.xs;
  float* act_all = sm.act_all;
  int* sel = sm.sel;
  float* sel_dist = sm.sel_dist;
  float* target = sm.target;
  float* act = sm.act;               // act_n (K), then act_l (n_lim)
  float* step = sm.step;
  float* bvec = sm.bvec;
  float* lam = sm.lam;

  // the state and targets; kpe and dtau stay 0 on the dofs without a motor
  for (int i = tid; i < rs; i += nt) stbuf[0][i] = st_in[i];
  for (int i = tid; i < 4 * S; i += nt) tgt_sph[i] = tgt_sph_in[i];
  for (int i = tid; i < NR; i += nt) tgt_rev[i] = tgt_rev_in[i];
  for (int i = tid; i < n; i += nt) { kpe[i] = 0.0f; dtau[i] = 0.0f; }
  BL_SYNC();

  int cur = 0;
  for (int sub = 0; sub < substeps; ++sub) {
    const float* st = stbuf[cur];
    float* stn = stbuf[cur ^ 1];
    const float* base_quat = st;
    const float* base_pos = st + 4;
    const float* base_ang = st + 7;
    const float* base_lin = st + 10;
    const float* q_sph = st + 13;
    const float* w_sph = st + 13 + 4 * S;
    const float* q_rev = st + 13 + 7 * S;
    const float* w_rev = st + 13 + 7 * S + NR;

    // ================= FK, world and base frames, level by level =========
    // H and C are taken in the frame of the base body (origin at the base,
    // axes along it), from a second FK that starts at the identity; the
    // TPU kernel takes them about the world origin with world axes. The
    // result does not depend on the frame, its fp32 rounding does: in the
    // base frame the base dofs' columns are exact unit vectors, as in the
    // body-frame CRBA of the plain version, and lever arms do not grow with
    // the distance walked. Contacts and integration keep the world FK.
    {
      const float q0[4] = {0.0f, 0.0f, 0.0f, 1.0f}, p0[3] = {0.0f, 0.0f, 0.0f};
      for (int lev = 0; lev < levels; ++lev) {
        const int lo = T.level_off[lev], cnt = T.level_off[lev + 1] - lo;
        for (int i = tid; i < 2 * cnt; i += nt) {
          if (i < cnt)
            fk_body(T, q_sph, q_rev, base_quat, base_pos, T.order[lo + i], qw, pw, Rw);
          else
            fk_body(T, q_sph, q_rev, q0, p0, T.order[lo + i - cnt], qb, pb, Rb);
        }
        BL_SYNC();
      }
    }

    // ====== per dof, per body, per candidate, per motor, per limit row ======
    {
      int base = 0;
      // generalized velocity, Jacobian columns (base frame), world axes
      for (int d = first_item(tid, nt, base); d < n; d += nt) {
        const int b = T.dof_body[d];
        if (d < 6) {
          const float vd = Rtv_i(Rw[0], d < 3 ? base_ang : base_lin, d % 3);
          v[d] = vd;
          vhat[0][d] = vd;        // the base's spatial velocity (base frame)
          abias[0][d] = 0.0f;
        } else if (T.jtype[b] == 1) {
          v[d] = w_sph[3 * T.sph_index[b] + d - T.dof_offset[b]];
        } else {
          v[d] = w_rev[T.rev_index[b]];
        }
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
      base += n;
      // per-body spatial inertia about the base (base frame),
      // I_O = [[I_cw + m cx cx^T, m cx], [-m cx, m 1]] (ang; lin), and the
      // starting terms of the composites
      for (int b = first_item(tid, nt, base); b < nb; b += nt) {
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
          fm[b][i] = m * cw[i];
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
      base += nb;
      // contact candidates. Top-K runs on the distances plus the static
      // tie-break (c+1)*1e-7, which makes each minimum unique (a level foot
      // puts four corners at one height). The tie-break only orders the
      // selection: flags, activity and Baumgarte targets use the true
      // distance, as sim/contact.py does (the TPU kernel feeds the shifted
      // distance to them, up to 4e-4 m/s off the reference targets).
      for (int c = first_item(tid, nt, base); c < nc; c += nt) {
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
      base += nc;
      // SPD errors of the motors: kpe = kp e - kd w
      for (int mi = first_item(tid, nt, base); mi < n_m; mi += nt) {
        if (mi < n_sm) {
          const int d0 = T.sph_motor_dof[mi], s = T.sph_motor_idx[mi];
          float ex[4], qp[4], qc[4], dq[4], ep[3];
          qexp_scaled(w_sph + 3 * s, dt, ex);
          qmul(q_sph + 4 * s, ex, qp);
          qnormalize(qp);
          qc[0] = -qp[0]; qc[1] = -qp[1]; qc[2] = -qp[2]; qc[3] = qp[3];
          qmul(qc, tgt_sph + 4 * s, dq);
          q_axis_angle(dq, ep);
          for (int c = 0; c < 3; ++c)
            kpe[d0 + c] = T.kp[d0 + c] * ep[c] - T.kd[d0 + c] * w_sph[3 * s + c];
        } else {
          const int m = mi - n_sm;
          const int d0 = T.rev_motor_dof[m], rv = T.rev_motor_idx[m];
          const float pred = q_rev[rv] + w_rev[rv] * dt;
          kpe[d0] = T.kp[d0] * (tgt_rev[rv] - pred) - T.kd[d0] * w_rev[rv];
        }
      }
      base += n_m;
      // joint-limit rows: activity and Baumgarte targets
      for (int li = first_item(tid, nt, base); li < NL; li += nt) {
        const float viol = T.lim_sign[li] * (T.lim_val[li] - q_rev[T.lim_rev[li]]);
        act[K + li] = viol > 0.0f ? 1.0f : 0.0f;
        target[K3 + li] = T.limit_erp_dt * fmaxf(viol, 0.0f);
      }
    }
    BL_SYNC();

    // ====== top-K; composites bottom-up beside velocities top-down ======
    // Composite inertias of each subtree in centre-of-mass form: mass mc,
    // centre of mass ccom and rotational inertia jc about that centre. The
    // TPU kernel sums 6x6 inertias about one common origin instead; there a
    // light body far from the origin (a foot, ~1 m from the base)
    // contributes m |c|^2 ~ 1 to entries whose result is ~5e-3, and fp32
    // cancellation costs the ill-conditioned H (cond ~ 4e4) three digits.
    // Every lever arm below is taken from a subtree's own centre of mass.
    // A body gathers its children's finished sums (last in `order` first,
    // the order in which the one-thread version added them).
    for (int s = 0; s < levels; ++s) {
      int base = 0;
      if (s == 0) {
#ifdef __CUDA_ARCH__
        // 16 argmins over (keyed distance, index) by the first warp: lane l
        // holds candidates l and l + 32
        if (tid < 32) {
          const int lane = tid;
          float d0 = lane < nc ? dwork[lane] : INFINITY;
          float d1 = lane + 32 < nc ? dwork[lane + 32] : INFINITY;
          for (int j = 0; j < K; ++j) {
            float bd = d0;
            int bi = lane;
            if (d1 < d0) { bd = d1; bi = lane + 32; }
            for (int o = 16; o > 0; o >>= 1) {
              const float od = __shfl_xor_sync(0xffffffffu, bd, o);
              const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
              if (od < bd || (od == bd && oi < bi)) { bd = od; bi = oi; }
            }
            if (bi == lane) d0 = 1e30f;
            else if (bi == lane + 32) d1 = 1e30f;
            if (lane == 0) {
              sel[j] = bi;
              sel_dist[j] = dist[bi];
            }
          }
        }
#else
        if (tid == 0) {
          for (int j = 0; j < K; ++j) {
            int sj = 0;
            for (int c = 1; c < nc; ++c)
              if (dwork[c] < dwork[sj]) sj = c;
            dwork[sj] = 1e30f;
            sel[j] = sj;
            sel_dist[j] = dist[sj];
          }
        }
#endif
      }
      {
        const int lev = levels - 1 - s;
        const int lo = T.level_off[lev], cnt = T.level_off[lev + 1] - lo;
        for (int i = first_item(tid, nt, base); i < cnt; i += nt) {
          const int p = T.order[lo + i];
          float m = T.mass[p];
          for (int k = T.child_off[p]; k < T.child_off[p + 1]; ++k) {
            const int c = T.child[k];
            m += mc[c];
            for (int q = 0; q < 3; ++q) fm[p][q] += fm[c][q];   // first moments
          }
          mc[p] = m;
          const float inv = 1.0f / fmaxf(m, 1e-12f);
          float rr[3];
          for (int q = 0; q < 3; ++q) {
            ccom[p][q] = fm[p][q] * inv;
            rr[q] = bcom[p][q] - ccom[p][q];
          }
          add_parallel_axis(jc[p], T.mass[p], rr);
          for (int k = T.child_off[p]; k < T.child_off[p + 1]; ++k) {
            const int c = T.child[k];
            for (int q = 0; q < 3; ++q) rr[q] = ccom[c][q] - ccom[p][q];
            for (int q = 0; q < 9; ++q) jc[p][q] += jc[c][q];
            add_parallel_axis(jc[p], mc[c], rr);
          }
        }
        base += cnt;
      }
      if (s + 1 < levels) {
        // C: fixed-frame bias recursion, velocities and bias accelerations
        const int lo = T.level_off[s + 1], cnt = T.level_off[s + 2] - lo;
        for (int i = first_item(tid, nt, base); i < cnt; i += nt) {
          const int b = T.order[lo + i], p = T.parent[b], d = T.dof_offset[b];
          float add[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          for (int c = 0; c < T.dof_count[b]; ++c)
            for (int q = 0; q < 6; ++q) add[q] += col[d + c][q] * v[d + c];
          for (int q = 0; q < 6; ++q) vhat[b][q] = vhat[p][q] + add[q];
          float dvj[6], cr[6];
          for (int q = 0; q < 6; ++q) dvj[q] = vhat[b][q] - vhat[p][q];
          crm6(vhat[b], dvj, cr);
          for (int q = 0; q < 6; ++q) abias[b][q] = abias[p][q] + cr[q];
        }
      }
      BL_SYNC();
    }

    // ====== bias forces bottom-up; H; contact rows and targets ======
    for (int s = 0; s < levels; ++s) {
      int base = 0;
      {
        const int lev = levels - 1 - s;
        const int lo = T.level_off[lev], cnt = T.level_off[lev + 1] - lo;
        for (int i = first_item(tid, nt, base); i < cnt; i += nt) {
          const int b = T.order[lo + i];
          float grav[3], av[6], iav[6], iv[6], cf[6];
          for (int q = 0; q < 3; ++q) grav[q] = Rtv_i(Rw[0], T.gravity, q);
          for (int q = 0; q < 6; ++q) av[q] = abias[b][q] - (q < 3 ? 0.0f : grav[q - 3]);
          for (int q = 0; q < 6; ++q) {
            float s1 = io[b][6 * q] * av[0], s2 = io[b][6 * q] * vhat[b][0];
            for (int c = 1; c < 6; ++c) {
              s1 += io[b][6 * q + c] * av[c];
              s2 += io[b][6 * q + c] * vhat[b][c];
            }
            iav[q] = s1;
            iv[q] = s2;
          }
          crf6(vhat[b], iv, cf);
          float acc6[6];
          for (int q = 0; q < 6; ++q) acc6[q] = iav[q] + cf[q];
          for (int k = T.child_off[b]; k < T.child_off[b + 1]; ++k)
            for (int q = 0; q < 6; ++q) acc6[q] += fb[T.child[k]][q];
          for (int q = 0; q < 6; ++q) fb[b][q] = acc6[q];
        }
        base += cnt;
      }
      if (s == 0) {
        // H on the static ancestor-pair sparsity, one thread per element of
        // the upper triangle: H[d, e] = col_d . IC_b(e) col_e, both columns
        // about the centre of mass of the subtree of body(e), where IC is
        // block-diagonal; written into H and both matrices to invert
        const int cnt = n * (n + 1) / 2;
        int e = 0, d = first_item(tid, nt, base);
        while (d > e) { d -= e + 1; ++e; }   // item -> (d <= e), by columns
        for (int i = first_item(tid, nt, base); i < cnt; i += nt) {
          const int be = T.dof_body[e];
          float h = 0.0f;
          if ((T.anc[be] >> T.dof_body[d]) & 1u) {
            float ae[3], le[3], ya[3], yl[3], ad[3], ld[3];
            col_about(T, col, pb, ccom[be], e, ae, le);
            for (int q = 0; q < 3; ++q) {
              ya[q] = jc[be][3 * q] * ae[0] + jc[be][3 * q + 1] * ae[1] + jc[be][3 * q + 2] * ae[2];
              yl[q] = mc[be] * le[q];
            }
            col_about(T, col, pb, ccom[be], d, ad, ld);
            h = ad[0] * ya[0] + ad[1] * ya[1] + ad[2] * ya[2]
                + ld[0] * yl[0] + ld[1] * yl[1] + ld[2] * yl[2];
          }
          H[d * n + e] = h;
          H[e * n + d] = h;
          Minv[d * n + e] = d == e ? h + T.minv_diag[d] : h;
          Minv[e * n + d] = d == e ? h + T.minv_diag[d] : h;
          Hinv[d * n + e] = d == e ? h + T.eps : h;
          Hinv[e * n + d] = d == e ? h + T.eps : h;
          d += nt;
          while (d > e) { d -= e + 1; ++e; }
        }
        base += cnt;
      }
      if (s == (levels > 1 ? 1 : 0)) {
        // contact rows of the selected points, world frame: the normal
        // (up) rows, then the two tangents, one thread per (contact, dof)
        for (int i = first_item(tid, nt, base); i < K * n; i += nt) {
          const int j = i / n, d = i - j * n;
          const int sj = sel[j];
          const float* sx = xs[sj];
          const unsigned int anc = T.anc[T.cand_body[sj]];
          float jr[3] = {0.0f, 0.0f, 0.0f};
          if ((anc >> T.dof_body[d]) & 1u) {
            if (T.dof_is_linear[d]) {
              for (int q = 0; q < 3; ++q) jr[q] = waxis[d][q];
            } else {
              const float* ap = pw[T.dof_body[d]];
              const float diff[3] = {sx[0] - ap[0], sx[1] - ap[1], sx[2] - ap[2]};
              cross3(waxis[d], diff, jr);
            }
          }
          rows[j * ldr + d] = jr[up];
          rows[(K + j) * ldr + d] = jr[t1x];
          rows[(2 * K + j) * ldr + d] = jr[t2x];
        }
        base += K * n;
        for (int j = first_item(tid, nt, base); j < K; j += nt) {
          const float pen = fmaxf(-sel_dist[j] - T.slop, 0.0f);
          target[j] = T.erp_dt * pen;
          act[j] = sel_dist[j] < 0.0f ? 1.0f : 0.0f;
          target[K + j] = 0.0f;
          target[2 * K + j] = 0.0f;
        }
      }
      BL_SYNC();
    }

    // ============ f = kpe - C; the two inverses ============
    for (int d = tid; d < n; d += nt) {
      f[d] = -dot_in_order(col[d], 1, fb[T.dof_body[d]], 1, 6) + kpe[d];
    }
    // (the sweep's first barrier orders f before its readers)
    gj_sweep_pair(Hinv, n, sm.gj, tid, nt);

    // ====== a = Minv f, refined; W = Hinv J^T beside it ======
    // Each solve through an explicit inverse gets one refinement step
    // against the kept H (the TPU kernel has none): the clamp correction
    // goes through cond(H) ~ 4e4, and this halves its fp32 error.
    {
      int base = 0;
      for (int i = first_item(tid, nt, base); i < n; i += nt)
        a[i] = dot_in_order(Minv + i * n, 1, f, 1, n);
      base += n;
      // W[k, j], W[k, K + j], W[k, 2K + j] for one (dof, contact)
      for (int i = first_item(tid, nt, base); i < n * K; i += nt) {
        const int k = i / K, j = i - k * K;
        float s0, s1, s2;   // locals: sums kept in W itself would be stored every term
        dot3_in_order(rows + j * ldr, rows + (K + j) * ldr, rows + (2 * K + j) * ldr,
                      Hinv + k * n, n, s0, s1, s2);
        W[k * ldw + j] = s0;
        W[k * ldw + K + j] = s1;
        W[k * ldw + 2 * K + j] = s2;
      }
      base += n * K;
      for (int i = first_item(tid, nt, base); i < n * NL; i += nt) {
        const int k = i / NL, li = i - k * NL;
        W[k * ldw + K3 + li] = T.lim_sign[li] * Hinv[k * n + T.lim_dof[li]];
      }
    }
    BL_SYNC();
    for (int i = tid; i < n; i += nt)
      r[i] = f[i] - (dot_in_order(H + i * n, 1, a, 1, n) + T.minv_diag[i] * a[i]);
    BL_SYNC();
    for (int i = tid; i < n; i += nt) a[i] += dot_in_order(Minv + i * n, 1, r, 1, n);
    BL_SYNC();

    // torque-clamp correction on the motor dofs
    for (int mi = tid; mi < n_m; mi += nt) {
      if (mi < n_sm) {
        const int d0 = T.sph_motor_dof[mi];
        const float lim = T.sph_motor_lim[mi];
        float t3[3];
        for (int c = 0; c < 3; ++c) t3[c] = kpe[d0 + c] - T.kd_dt[d0 + c] * a[d0 + c];
        const float nrm = sqrtf(t3[0] * t3[0] + t3[1] * t3[1] + t3[2] * t3[2]);
        const float scale = nrm > lim ? lim / fmaxf(nrm, 1e-9f) : 1.0f;
        for (int c = 0; c < 3; ++c) dtau[d0 + c] = t3[c] * (scale - 1.0f);
      } else {
        const int m = mi - n_sm;
        const int d0 = T.rev_motor_dof[m];
        const float lim = T.rev_motor_lim[m];
        const float t1 = kpe[d0] - T.kd_dt[d0] * a[d0];
        dtau[d0] = fminf(fmaxf(t1, -lim), lim) - t1;
      }
    }
    BL_SYNC();
    for (int i = tid; i < n; i += nt) tmp[i] = dot_in_order(Hinv + i * n, 1, dtau, 1, n);
    BL_SYNC();
    for (int i = tid; i < n; i += nt)
      r[i] = dtau[i] - (dot_in_order(H + i * n, 1, tmp, 1, n) + T.eps * tmp[i]);
    BL_SYNC();
    for (int i = tid; i < n; i += nt) {
      tmp[i] += dot_in_order(Hinv + i * n, 1, r, 1, n);
      vstar[i] = v[i] + dt * (a[i] + tmp[i]);
    }
    BL_SYNC();

    // ====== |A| on the upper triangle; b = J v* - target ======
    // the contact block of A = J W on the upper triangle (A is symmetric;
    // it steers the step only), in the space of Minv and H
    {
      int base = 0;
      const int cnt = K3 * (K3 + 1) / 2;
      int jj = 0, ii = first_item(tid, nt, base);
      while (ii > jj) { ii -= jj + 1; ++jj; }   // item -> (ii <= jj)
      for (int i = first_item(tid, nt, base); i < cnt; i += nt) {
        A[ii * K3 + jj] = fabsf(dot_in_order(rows + ii * ldr, 1, W + jj, ldw, n));
        ii += nt;
        while (ii > jj) { ii -= jj + 1; ++jj; }
      }
      base += cnt;
      for (int i = first_item(tid, nt, base); i < K3; i += nt) {
        bvec[i] = dot_in_order(rows + i * ldr, 1, vstar, 1, n) - target[i];
        lam[i] = 0.0f;
      }
      base += K3;
      for (int li = first_item(tid, nt, base); li < NL; li += nt) {
        bvec[K3 + li] = T.lim_sign[li] * vstar[T.lim_dof[li]] - target[K3 + li];
        lam[K3 + li] = 0.0f;
      }
    }
    BL_SYNC();
    // Gershgorin row sums -> Jacobi steps, one thread per row, summed in
    // the order the one-thread version accumulated them
    for (int i = tid; i < R; i += nt) {
      float s = 0.0f;
      if (i < K3) {
        for (int j = 0; j < i; ++j) s += A[j * K3 + i];
        for (int j = i; j < K3; ++j) s += A[i * K3 + j];
        // A[i, 3K+li] = sign * W[dof_li, i] (Hinv symmetric)
        for (int li = 0; li < NL; ++li) s += fabsf(W[T.lim_dof[li] * ldw + i]);
      } else {
        // limit row: A[3K+li, :] = sign * W[dof_li, :]
        const float* wrow = W + T.lim_dof[i - K3] * ldw;
        for (int j = 0; j < R; ++j) s += fabsf(wrow[j]);
      }
      step[i] = T.relaxation / fmaxf(s + T.cfm, 1e-9f);
    }
    BL_SYNC();

    // ============ projected Jacobi in W-form ============
    for (int it = 0; it < T.iterations; ++it) {
      for (int k = tid; k < n; k += nt) u[k] = dot_in_order(W + k * ldw, 1, lam, 1, R);
      BL_SYNC();
      for (int i = tid; i < K + NL; i += nt) {
        if (i < K) {
          const int j = i;
          float s0, s1, s2;
          dot3_in_order(rows + j * ldr, rows + (K + j) * ldr, rows + (2 * K + j) * ldr, u,
                        n, s0, s1, s2);
          const float upd0 = lam[j] - step[j] * (s0 + bvec[j]);
          const float upd1 = lam[K + j] - step[K + j] * (s1 + bvec[K + j]);
          const float upd2 = lam[2 * K + j] - step[2 * K + j] * (s2 + bvec[2 * K + j]);
          const float ln = fmaxf(upd0, 0.0f) * act[j];
          const float bound = T.mu * ln;
          lam[j] = ln;
          lam[K + j] = fminf(fmaxf(upd1, -bound), bound) * act[j];
          lam[2 * K + j] = fminf(fmaxf(upd2, -bound), bound) * act[j];
        } else {
          const int li = i - K, row = K3 + li;
          const float upd = lam[row] - step[row] * (T.lim_sign[li] * u[T.lim_dof[li]] + bvec[row]);
          lam[row] = fmaxf(upd, 0.0f) * act[K + li];
        }
      }
      BL_SYNC();
    }
    // v_new = clip(v* + W lam, +-100), kept in `u`
    for (int k = tid; k < n; k += nt)
      u[k] = fminf(fmaxf(vstar[k] + dot_in_order(W + k * ldw, 1, lam, 1, R), -100.0f), 100.0f);
    BL_SYNC();

    // ============ integrate (dynamics.advance semantics) ============
    // one thread for the base, one per joint; the new state goes into the
    // other state buffer
    for (int i = tid; i < 1 + S + NR; i += nt) {
      if (i == 0) {
        float dpos[3], ex[4], nq[4], R0n[9], na[3], nl[3];
        Rv(Rw[0], u + 3, dpos);
        qexp_scaled(u, dt, ex);
        qmul(base_quat, ex, nq);
        qnormalize(nq);
        q2R(nq, R0n);
        Rv(R0n, u, na);
        Rv(R0n, u + 3, nl);
        for (int q = 0; q < 4; ++q) stn[q] = nq[q];
        for (int q = 0; q < 3; ++q) {
          const float np = base_pos[q] + dt * dpos[q];
          stn[4 + q] = np;
          stn[7 + q] = na[q];
          stn[10 + q] = nl[q];
          hist_out[3 * sub + q] = np;
        }
      } else if (i <= S) {
        const int s = i - 1;
        const int d = T.dof_offset[T.sph_body[s]];
        float exs[4], qn[4];
        qexp_scaled(u + d, dt, exs);
        qmul(q_sph + 4 * s, exs, qn);
        qnormalize(qn);
        for (int c = 0; c < 4; ++c) stn[13 + 4 * s + c] = qn[c];
        for (int c = 0; c < 3; ++c) stn[13 + 4 * S + 3 * s + c] = u[d + c];
      } else {
        const int rv = i - 1 - S;
        const int d = T.dof_offset[T.rev_body[rv]];
        float q = q_rev[rv] + dt * u[d];
        if (T.rev_has_limit[rv]) q = fminf(fmaxf(q, T.rev_lo[rv]), T.rev_hi[rv]);
        stn[13 + 7 * S + rv] = q;
        stn[13 + 7 * S + NR + rv] = u[d];
      }
    }
    BL_SYNC();
    cur ^= 1;
  }

  const float* st = stbuf[cur];
  for (int i = tid; i < rs; i += nt) st_out[i] = st[i];
  for (int c = tid; c < nc; c += nt) act_out[c] = act_all[c];
  if constexpr (EMIT_LINKS) link_epilogue(T, st, qw, pw, Rw, vhat, links_out, tid, nt);
}

// ---- entry points -----------------------------------------------------------

// dynamic shared memory of one block (bytes)
static int ms_shared_bytes(const MegaTables& T) {
  return (int)(sizeof(float) * (size_t)ms_layout(T).total);
}

#ifdef __CUDACC__

// One block per env; the workspace is the dynamic shared memory.
template <bool EMIT_LINKS>
__global__ void __launch_bounds__(MS_MAX_THREADS, 2)
megastep_kernel(const MegaTables* __restrict__ tables, const float* __restrict__ st,
                const float* __restrict__ tgt_sph, const float* __restrict__ tgt_rev,
                float* __restrict__ st_out, float* __restrict__ act_out,
                float* __restrict__ hist_out, float* __restrict__ links_out,
                int substeps) {
  __shared__ MegaTables T;
  __shared__ MsSmall sm;
  extern __shared__ float ms_shared[];
  {
    const int* src = reinterpret_cast<const int*>(tables);
    int* dst = reinterpret_cast<int*>(&T);
    const int words = (int)(sizeof(MegaTables) / sizeof(int));
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const size_t env = blockIdx.x;
  const int rs = 13 + 7 * T.n_sph + 2 * T.n_rev;
  float* links = nullptr;
  if constexpr (EMIT_LINKS) links = links_out + env * MS_LINK_ROWS * T.n_links;
  megastep_block<EMIT_LINKS>(
      T, st + env * rs, tgt_sph + env * 4 * T.n_sph, tgt_rev + env * T.n_rev,
      st_out + env * rs, act_out + env * T.n_cand, hist_out + env * 3 * substeps,
      links, sm, ms_shared, substeps, threadIdx.x, blockDim.x);
}

template <bool EMIT_LINKS>
static int ms_launch(const MegaTables* tables, const float* st,
                     const float* tgt_sph, const float* tgt_rev, float* st_out,
                     float* act_out, float* hist_out, float* links_out, int B,
                     int substeps, int threads, int shared_bytes,
                     cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      megastep_kernel<EMIT_LINKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (err != cudaSuccess) return (int)err;
  megastep_kernel<EMIT_LINKS><<<B, threads, shared_bytes, stream>>>(
      tables, st, tgt_sph, tgt_rev, st_out, act_out, hist_out, links_out, substeps);
  return (int)cudaGetLastError();
}

// Launch on `stream`, one block of `threads` threads per env (0: the
// default MS_THREADS), with `shared_bytes` of dynamic shared memory
// (pfpn_megastep_shared_bytes of the host copy of the tables): the
// emit_links variant when links_out is not null, else the default one.
// Returns a cudaError_t (0 = launched).
extern "C" int pfpn_megastep_launch(const void* tables, const float* st,
                                    const float* tgt_sph, const float* tgt_rev,
                                    float* st_out, float* act_out,
                                    float* hist_out, float* links_out, int B,
                                    int substeps, int threads, int shared_bytes,
                                    void* stream) {
  if (threads <= 0) threads = MS_THREADS;
  if (threads % 32 != 0 || threads > MS_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const MegaTables* t = (const MegaTables*)tables;
  if (links_out)
    return ms_launch<true>(t, st, tgt_sph, tgt_rev, st_out, act_out, hist_out,
                           links_out, B, substeps, threads, shared_bytes,
                           (cudaStream_t)stream);
  return ms_launch<false>(t, st, tgt_sph, tgt_rev, st_out, act_out, hist_out,
                          nullptr, B, substeps, threads, shared_bytes,
                          (cudaStream_t)stream);
}

#else

// Host build of the same block body (g++ -x c++), for the CPU tests:
// `threads` host threads run it env after env, with a std::barrier as
// BL_SYNC(); the emit_links variant when links_out is not null.
extern "C" int pfpn_megastep_host(const void* tables, const float* st,
                                  const float* tgt_sph, const float* tgt_rev,
                                  float* st_out, float* act_out,
                                  float* hist_out, float* links_out, int B,
                                  int substeps, int threads) {
  if (threads < 1) return 1;
  const MegaTables& T = *(const MegaTables*)tables;
  const int rs = 13 + 7 * T.n_sph + 2 * T.n_rev;
  std::vector<float> sh(ms_layout(T).total);
  std::vector<MsSmall> small(1);
  std::barrier<> bar(threads);
  auto body = [&](int tid) {
    ms_host_barrier = &bar;
    for (int env = 0; env < B; ++env) {
      const float* s = st + (size_t)env * rs;
      const float* ts = tgt_sph + (size_t)env * 4 * T.n_sph;
      const float* tr = tgt_rev + (size_t)env * T.n_rev;
      float* so = st_out + (size_t)env * rs;
      float* ao = act_out + (size_t)env * T.n_cand;
      float* ho = hist_out + (size_t)env * 3 * substeps;
      if (links_out)
        megastep_block<true>(T, s, ts, tr, so, ao, ho,
                             links_out + (size_t)env * MS_LINK_ROWS * T.n_links,
                             small[0], sh.data(), substeps, tid, threads);
      else
        megastep_block<false>(T, s, ts, tr, so, ao, ho, nullptr, small[0],
                              sh.data(), substeps, tid, threads);
      BL_SYNC();   // the next env reuses the workspace
    }
    ms_host_barrier = nullptr;
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(body, t);
  body(0);
  for (auto& th : pool) th.join();
  return 0;
}

#endif

extern "C" int pfpn_megastep_tables_bytes(void) { return (int)sizeof(MegaTables); }

extern "C" int pfpn_megastep_default_threads(void) { return MS_THREADS; }

extern "C" int pfpn_megastep_shared_bytes(const void* tables) {
  return ms_shared_bytes(*(const MegaTables*)tables);
}
