"""The 30 Hz control step as one CUDA kernel ("megastep"), and its plain version.

Counterpart of ``pfpn_tpu/ops/megastep.py``. :class:`MegaMeta`,
:func:`build_meta`, :func:`pack_state` and :func:`unpack_state` are ports of
``megastep.py:56-271``. The TPU kernel (``_make_kernel``, launched by
``megastep_pallas``) becomes ``csrc/megastep.cu``: hand-written CUDA C++ for
``sm_90a``, one thread block per environment with its whole workspace in
shared memory, compiled with ``nvcc`` at first use into ``build/`` and bound
with ctypes (``ops/_build.py``). :class:`Megastep` is the wrapper:

* on a CUDA tensor it launches the kernel on the current stream, raises if
  the launch is refused, and adds one to its variant's count;
* on a CPU tensor it runs the plain version, a Python loop of ``frame_skip``
  reference substeps (the engine's fused substep over the batched
  ``ops/substep_lin.py`` math), as ``make_megastep._primal`` does.

There is no fallback from one to the other. One :class:`Megastep` serves
both of the TPU kernel's variants: with ``links=True`` it runs the
``emit_links`` variant, whose kernel also writes the final link states (the
epilogue of ``megastep.py:994-1077``, a compile-time branch of the same
source) and whose plain version takes them from ``link_state_fn``.
``launches`` counts the default variant's launches, ``launches_links`` the
``emit_links`` variant's.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ._build import CudaSource

F3 = Tuple[float, float, float]
F4 = Tuple[float, float, float, float]

# capacities of the static tables (MS_MAX* in csrc/megastep.cu)
MAXB, MAXD, MAXC, MAXK, MAXL, MAXS, MAXR, MAXLK = 16, 40, 48, 16, 8, 12, 8, 16
# emit_links output rows per link (MS_LINK_ROWS): frame_pos(3), frame_quat(4),
# com_pos(3), com_quat(4), lin_vel(3), ang_vel(3), LinkStates field order
LINK_ROWS = 20


@dataclasses.dataclass(frozen=True)
class MegaMeta:
    ndof: int
    nb: int
    n_sph: int
    n_rev: int
    n_cand: int
    n_contacts: int          # K (top-K selected)
    n_lim: int
    frame_skip: int
    dt: float
    gravity: F3
    topo: Tuple[int, ...]
    parent: Tuple[int, ...]
    jtype: Tuple[int, ...]            # 0 free, 1 spherical, 2 revolute
    joint_pos: Tuple[F3, ...]
    joint_quat: Tuple[F4, ...]
    joint_axis: Tuple[F3, ...]
    sph_index: Tuple[int, ...]
    rev_index: Tuple[int, ...]
    dof_offset: Tuple[int, ...]
    dof_count: Tuple[int, ...]
    mass: Tuple[float, ...]
    com: Tuple[F3, ...]
    inertia_c: Tuple[Tuple[float, ...], ...]   # (nb, 9) rot inertia about CoM
    dof_body: Tuple[int, ...]
    dof_axis: Tuple[F3, ...]
    dof_is_linear: Tuple[bool, ...]
    kp: Tuple[float, ...]
    kd: Tuple[float, ...]
    sph_motors: Tuple[Tuple[int, float, int], ...]   # (dof, limit, sph_idx)
    rev_motors: Tuple[Tuple[int, float, int], ...]   # (dof, limit, rev_idx)
    rev_limits: Tuple[Tuple[int, float, float], ...]  # (rev_idx, lo, hi)
    cand_body: Tuple[int, ...]
    cand_off: Tuple[F3, ...]
    cand_radius: Tuple[float, ...]
    lim_rows: Tuple[Tuple[int, int, float, float], ...]  # (dof, rev_idx, value, sign)
    mu: float
    erp: float
    slop: float
    iterations: int
    relaxation: float
    cfm: float
    limit_erp: float
    up: int = 1
    eps: float = 1e-8
    link_body: Tuple[int, ...] = ()
    link_pos: Tuple[F3, ...] = ()
    link_quat: Tuple[F4, ...] = ()
    link_ipos: Tuple[F3, ...] = ()
    link_iquat: Tuple[F4, ...] = ()

    @property
    def rows_state(self) -> int:
        return 13 + 7 * self.n_sph + 2 * self.n_rev

    @property
    def n_rows(self) -> int:
        return 3 * self.n_contacts + self.n_lim

    @property
    def n_links(self) -> int:
        return len(self.link_body)


def build_meta(tree, gains, contact_params, contact_set, dt, frame_skip,
               gravity) -> MegaMeta:
    """Assemble a MegaMeta from the engine's static structures
    (megastep.py:146)."""
    from ..sim.types import FREE, REVOLUTE, SPHERICAL

    nb = tree.nb
    topo, seen = [], {-1}
    pending = list(range(nb))
    while pending:
        nxt = [b for b in pending if int(tree.parent[b]) in seen]
        if not nxt:
            raise ValueError("kinematic tree has a cycle")
        seen.update(nxt)
        topo += nxt
        pending = [b for b in pending if b not in seen]

    def t3(a):
        return tuple(float(x) for x in np.asarray(a).reshape(-1)[:3])

    inertia_c = []
    for b in range(nb):
        m = float(tree.mass[b])
        c = np.asarray(tree.com[b])
        i_o = np.asarray(tree.spatial_inertia[b])[:3, :3]
        cx = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
        inertia_c.append(tuple(float(x) for x in (i_o - m * cx @ cx.T).reshape(-1)))

    jt_map = {FREE: 0, SPHERICAL: 1, REVOLUTE: 2}
    sph_motors, rev_motors, rev_limits = [], [], []
    for mi, b in enumerate(tree.motor_bodies):
        d = int(tree.dof_offset[b])
        lim = float(tree.motor_torque_limit[mi])
        if tree.joint_type[b] == REVOLUTE:
            rev_motors.append((d, lim, int(tree.rev_index[b])))
            lo, hi = tree.motor_movement_limit[mi]
            if hi > lo:
                rev_limits.append((int(tree.rev_index[b]), float(lo), float(hi)))
        else:
            sph_motors.append((d, lim, int(tree.sph_index[b])))

    cs = contact_set
    lim_rows = tuple(
        (int(cs.limit_dof[i]), int(cs.limit_rev[i]),
         float(cs.limit_value[i]), float(cs.limit_sign[i]))
        for i in range(cs.limit_dof.shape[0]))
    n_cand = int(cs.body.shape[0])
    k = contact_params.max_contacts
    k = n_cand if (k is None or k >= n_cand) else int(k)

    return MegaMeta(
        ndof=tree.ndof, nb=nb, n_sph=tree.n_sph, n_rev=tree.n_rev,
        n_cand=n_cand, n_contacts=k, n_lim=len(lim_rows),
        frame_skip=frame_skip, dt=dt, gravity=t3(gravity),
        topo=tuple(topo[1:]),
        parent=tuple(int(x) for x in tree.parent),
        jtype=tuple(jt_map.get(t, -1) for t in tree.joint_type),
        joint_pos=tuple(t3(tree.joint_pos[b]) for b in range(nb)),
        joint_quat=tuple(tuple(float(x) for x in tree.joint_quat[b]) for b in range(nb)),
        joint_axis=tuple(t3(tree.joint_axis[b]) for b in range(nb)),
        sph_index=tuple(int(x) for x in tree.sph_index),
        rev_index=tuple(int(x) for x in tree.rev_index),
        dof_offset=tuple(int(x) for x in tree.dof_offset),
        dof_count=tuple(int(x) for x in tree.dof_count),
        mass=tuple(float(x) for x in tree.mass),
        com=tuple(t3(tree.com[b]) for b in range(nb)),
        inertia_c=tuple(inertia_c),
        dof_body=tuple(int(x) for x in cs.dof_body),
        dof_axis=tuple(t3(cs.dof_axis_local[d]) for d in range(tree.ndof)),
        dof_is_linear=tuple(bool(x) for x in cs.dof_is_linear),
        kp=tuple(float(x) for x in gains.kp),
        kd=tuple(float(x) for x in gains.kd),
        sph_motors=tuple(sph_motors), rev_motors=tuple(rev_motors),
        rev_limits=tuple(rev_limits),
        cand_body=tuple(int(x) for x in cs.body),
        cand_off=tuple(t3(cs.offset[c]) for c in range(n_cand)),
        cand_radius=tuple(float(x) for x in cs.radius),
        lim_rows=lim_rows,
        mu=contact_params.mu, erp=contact_params.erp,
        slop=contact_params.slop, iterations=contact_params.iterations,
        relaxation=contact_params.relaxation, cfm=contact_params.cfm,
        limit_erp=contact_params.limit_erp, up=contact_params.up_dir,
        link_body=tuple(int(x) for x in tree.link_body),
        link_pos=tuple(t3(tree.link_pos[i]) for i in range(tree.link_pos.shape[0])),
        link_quat=tuple(tuple(float(x) for x in tree.link_quat[i])
                        for i in range(tree.link_quat.shape[0])),
        link_ipos=tuple(t3(tree.link_inertial_pos[i])
                        for i in range(tree.link_inertial_pos.shape[0])),
        link_iquat=tuple(tuple(float(x) for x in tree.link_inertial_quat[i])
                         for i in range(tree.link_inertial_quat.shape[0])),
    )


# ---------------------------------------------------------------------------
# packing (SimState <-> (B, rows_state) matrix)
# ---------------------------------------------------------------------------

def pack_state(meta: MegaMeta, state) -> torch.Tensor:
    """SimState (B, ...) -> (B, rows_state), the ``pack_state`` layout."""
    B = state.base_pos.shape[0]
    return torch.cat([state.base_quat, state.base_pos, state.base_ang,
                      state.base_lin, state.q_sph.reshape(B, -1),
                      state.w_sph.reshape(B, -1), state.q_rev, state.w_rev], -1)


def unpack_state(meta: MegaMeta, mat: torch.Tensor, template):
    s, r = meta.n_sph, meta.n_rev
    B = mat.shape[0]
    i = 13
    return template.replace(
        base_quat=mat[:, 0:4], base_pos=mat[:, 4:7],
        base_ang=mat[:, 7:10], base_lin=mat[:, 10:13],
        q_sph=mat[:, i:i + 4 * s].reshape(B, s, 4),
        w_sph=mat[:, i + 4 * s:i + 7 * s].reshape(B, s, 3),
        q_rev=mat[:, i + 7 * s:i + 7 * s + r],
        w_rev=mat[:, i + 7 * s + r:i + 7 * s + 2 * r],
    )


# ---------------------------------------------------------------------------
# static tables for the kernel (struct MegaTables in csrc/megastep.cu)
# ---------------------------------------------------------------------------

_I, _U, _F = ctypes.c_int32, ctypes.c_uint32, ctypes.c_float


class MegaTables(ctypes.Structure):
    _fields_ = [(name, _I) for name in (
        "ndof", "nb", "n_sph", "n_rev", "n_cand", "K", "n_lim", "frame_skip",
        "up", "iterations", "n_sph_motors", "n_rev_motors", "n_levels")] + [
        ("order", _I * MAXB), ("level_off", _I * (MAXB + 1)),
        ("child_off", _I * (MAXB + 1)), ("child", _I * MAXB),
        ("parent", _I * MAXB), ("jtype", _I * MAXB),
        ("sph_index", _I * MAXB), ("rev_index", _I * MAXB),
        ("dof_offset", _I * MAXB), ("dof_count", _I * MAXB),
        ("anc", _U * MAXB),
        ("dof_body", _I * MAXD), ("dof_is_linear", _I * MAXD),
        ("sph_body", _I * MAXS), ("rev_body", _I * MAXR),
        ("sph_motor_dof", _I * MAXS), ("sph_motor_idx", _I * MAXS),
        ("rev_motor_dof", _I * MAXR), ("rev_motor_idx", _I * MAXR),
        ("rev_has_limit", _I * MAXR),
        ("cand_body", _I * MAXC),
        ("lim_dof", _I * MAXL), ("lim_rev", _I * MAXL),
    ] + [(name, _F) for name in (
        "dt", "mu", "slop", "relaxation", "cfm", "eps", "erp_dt",
        "limit_erp_dt")] + [
        ("gravity", _F * 3),
        ("joint_pos", _F * (3 * MAXB)), ("joint_quat", _F * (4 * MAXB)),
        ("joint_axis", _F * (3 * MAXB)), ("mass", _F * MAXB),
        ("com", _F * (3 * MAXB)), ("inertia_c", _F * (9 * MAXB)),
        ("dof_axis", _F * (3 * MAXD)), ("kp", _F * MAXD), ("kd", _F * MAXD),
        ("kd_dt", _F * MAXD), ("minv_diag", _F * MAXD),
        ("sph_motor_lim", _F * MAXS), ("rev_motor_lim", _F * MAXR),
        ("rev_lo", _F * MAXR), ("rev_hi", _F * MAXR),
        ("cand_off", _F * (3 * MAXC)), ("cand_radius", _F * MAXC),
        ("cand_tie", _F * MAXC),
        ("lim_val", _F * MAXL), ("lim_sign", _F * MAXL),
        ("n_links", _I), ("link_body", _I * MAXLK),
        ("link_pos", _F * (3 * MAXLK)), ("link_quat", _F * (4 * MAXLK)),
        ("link_ipos", _F * (3 * MAXLK)), ("link_iquat", _F * (4 * MAXLK)),
    ]


def _body_of(meta: MegaMeta, jtype: int, index, i: int) -> int:
    for b in range(meta.nb):
        if meta.jtype[b] == jtype and index[b] == i:
            return b
    raise KeyError(i)


def pack_tables(meta: MegaMeta) -> MegaTables:
    """Fill the kernel's static tables; raise if the tree exceeds them."""
    n, K = meta.ndof, meta.n_contacts
    limits = {"bodies": (meta.nb, MAXB), "dofs": (n, MAXD),
              "candidates": (meta.n_cand, MAXC), "contacts": (K, MAXK),
              "limit rows": (meta.n_lim, MAXL),
              "spherical joints": (meta.n_sph, MAXS),
              "revolute joints": (meta.n_rev, MAXR),
              "links": (meta.n_links, MAXLK)}
    for what, (have, cap) in limits.items():
        if have > cap:
            raise ValueError(f"megastep kernel takes at most {cap} {what}, "
                             f"got {have}")
    if meta.jtype[0] != 0 or any(j not in (1, 2) for j in meta.jtype[1:]):
        raise ValueError("megastep kernel needs a free base and spherical or "
                         "revolute joints")
    if meta.parent[0] != -1 or sorted(meta.topo) != list(range(1, meta.nb)):
        raise ValueError("megastep kernel needs body 0 as the root and every "
                         "other body in topo")

    t = MegaTables()
    for name, val in (("ndof", n), ("nb", meta.nb), ("n_sph", meta.n_sph),
                      ("n_rev", meta.n_rev), ("n_cand", meta.n_cand),
                      ("K", K), ("n_lim", meta.n_lim),
                      ("frame_skip", meta.frame_skip), ("up", meta.up),
                      ("iterations", meta.iterations),
                      ("n_sph_motors", len(meta.sph_motors)),
                      ("n_rev_motors", len(meta.rev_motors))):
        setattr(t, name, val)

    def fill(name, values):
        arr = getattr(t, name)
        flat = np.asarray(values, dtype=np.float64).reshape(-1)
        for i, x in enumerate(flat):
            arr[i] = x.item() if isinstance(arr[0], float) else int(x)

    # the tree level by level (the kernel's phases): the root, then the
    # other bodies by depth in topo order; each body's children, last in
    # that order first (the order the composites and bias forces sum them)
    depth = [0] * meta.nb
    for b in meta.topo:
        depth[b] = depth[meta.parent[b]] + 1
    order = [0] + sorted(meta.topo, key=lambda b: depth[b])
    t.n_levels = max(depth) + 1
    fill("order", order)
    fill("level_off", [sum(1 for b in order if depth[b] < lev)
                       for lev in range(t.n_levels + 1)])
    children = [[b for b in reversed(order) if meta.parent[b] == p]
                for p in range(meta.nb)]
    fill("child_off", np.cumsum([0] + [len(c) for c in children]))
    fill("child", [b for c in children for b in c])
    fill("parent", meta.parent)
    fill("jtype", meta.jtype)
    fill("sph_index", meta.sph_index)
    fill("rev_index", meta.rev_index)
    fill("dof_offset", meta.dof_offset)
    fill("dof_count", meta.dof_count)
    for b in range(meta.nb):
        mask, j = 0, b
        while j >= 0:
            mask |= 1 << j
            j = meta.parent[j]
        t.anc[b] = mask
    fill("dof_body", meta.dof_body)
    fill("dof_is_linear", [int(x) for x in meta.dof_is_linear])
    fill("sph_body", [_body_of(meta, 1, meta.sph_index, s) for s in range(meta.n_sph)])
    fill("rev_body", [_body_of(meta, 2, meta.rev_index, r) for r in range(meta.n_rev)])
    fill("sph_motor_dof", [m[0] for m in meta.sph_motors])
    fill("sph_motor_idx", [m[2] for m in meta.sph_motors])
    fill("rev_motor_dof", [m[0] for m in meta.rev_motors])
    fill("rev_motor_idx", [m[2] for m in meta.rev_motors])
    fill("cand_body", meta.cand_body)
    fill("lim_dof", [r[0] for r in meta.lim_rows])
    fill("lim_rev", [r[1] for r in meta.lim_rows])
    for r, lo, hi in meta.rev_limits:
        t.rev_has_limit[r] = 1
        t.rev_lo[r] = lo
        t.rev_hi[r] = hi

    t.dt, t.mu, t.slop = meta.dt, meta.mu, meta.slop
    t.relaxation, t.cfm, t.eps = meta.relaxation, meta.cfm, meta.eps
    # products of static constants rounded once from double, as the TPU
    # kernel bakes them into float literals
    t.erp_dt = meta.erp / meta.dt
    t.limit_erp_dt = meta.limit_erp / meta.dt
    fill("gravity", meta.gravity)
    fill("joint_pos", meta.joint_pos)
    fill("joint_quat", meta.joint_quat)
    fill("joint_axis", meta.joint_axis)
    fill("mass", meta.mass)
    fill("com", meta.com)
    fill("inertia_c", meta.inertia_c)
    fill("dof_axis", meta.dof_axis)
    fill("kp", meta.kp)
    fill("kd", meta.kd)
    fill("kd_dt", [k * meta.dt for k in meta.kd])
    fill("minv_diag", [k * meta.dt + meta.eps for k in meta.kd])
    fill("sph_motor_lim", [m[1] for m in meta.sph_motors])
    fill("rev_motor_lim", [m[1] for m in meta.rev_motors])
    fill("cand_off", meta.cand_off)
    fill("cand_radius", meta.cand_radius)
    fill("cand_tie", [(c + 1) * 1e-7 for c in range(meta.n_cand)])
    fill("lim_val", [r[2] for r in meta.lim_rows])
    fill("lim_sign", [r[3] for r in meta.lim_rows])
    t.n_links = meta.n_links
    fill("link_body", meta.link_body)
    fill("link_pos", meta.link_pos)
    fill("link_quat", meta.link_quat)
    fill("link_ipos", meta.link_ipos)
    fill("link_iquat", meta.link_iquat)
    return t


def links_to_states(meta: MegaMeta, arr: torch.Tensor):
    """(..., LINK_ROWS * n_links) kernel rows -> sim.dynamics.LinkStates
    (megastep.py:1293)."""
    from ..sim.dynamics import LinkStates

    a = arr.reshape(arr.shape[:-1] + (meta.n_links, LINK_ROWS))
    return LinkStates(frame_pos=a[..., 0:3], frame_quat=a[..., 3:7],
                      com_pos=a[..., 7:10], com_quat=a[..., 10:14],
                      lin_vel=a[..., 14:17], ang_vel=a[..., 17:20])


def states_to_links(ls) -> torch.Tensor:
    """LinkStates (B, n_links, ...) -> (B, LINK_ROWS * n_links) rows, the
    kernel's layout."""
    rows = torch.cat([ls.frame_pos, ls.frame_quat, ls.com_pos, ls.com_quat,
                      ls.lin_vel, ls.ang_vel], -1)
    return rows.reshape(rows.shape[0], -1)


def megastep_flops(meta: MegaMeta, substeps: Optional[int] = None,
                   emit_links: bool = False) -> int:
    """fp32 operations one env's control step needs, for the kernel's bound
    (an FMA counts two; sqrt, division and the transcendentals count one).
    Most terms follow the loops of csrc/megastep.cu; the two inverses count
    as the least they need, a Cholesky factor each (n^3/3) and one solve
    each (2 n^2), where the kernel runs two full Gauss-Jordan sweeps and
    refines each solve once. ``emit_links`` adds the epilogue: one FK, the
    spatial-velocity pass and each link's pose and velocity. The work does
    not depend on the data."""
    n, K, nb, C = meta.ndof, meta.n_contacts, meta.nb, meta.n_cand
    K3, R, it, L = 3 * K, meta.n_rows, meta.iterations, meta.n_lim
    pairs = 0                                  # ancestor-or-self dof pairs
    for e in range(n):
        chain, j = set(), meta.dof_body[e]
        while j >= 0:
            chain.add(j)
            j = meta.parent[j]
        pairs += sum(1 for d in range(e + 1) if meta.dof_body[d] in chain)
    n_sph_m, n_rev_m = len(meta.sph_motors), len(meta.rev_motors)
    per_sub = (
        2 * (nb - 1) * 120                        # FK, world and base frame
        + 30 + 40 * n                             # velocity, columns
        + nb * 200                                # body inertias
        + nb * 90                                 # composites, com form
        + 30 * n + 23 * pairs                     # H
        + nb * 260 + 12 * n                       # bias forces, C
        + 120 * n_sph_m + 10 * n_rev_m            # SPD errors
        + 2 * (n ** 3 // 3)                       # two Cholesky factors
        + 2 * 2 * n * n                           # two solves
        + 10 * (n_sph_m + n_rev_m) + 3 * n        # torque clamp, v*
        + 25 * C + K * (C + 12 * n)              # candidates, top-K rows
        + 2 * n * n * K3 + n * L                  # W
        + (K3 * (K3 + 1) // 2) * (2 * n + 3)      # |A| row sums
        + L * (K3 + R) * 2 + 3 * R                # limit sums, step
        + K3 * 2 * n + L                          # b = J v*
        + it * (2 * n * R + K3 * 2 * n + 11 * R)  # Jacobi sweeps
        + 2 * n * R + 2 * n                       # v* + W lam, clip
        + 80 + 60 * meta.n_sph + 6 * meta.n_rev)  # integration
    total = per_sub * (meta.frame_skip if substeps is None else substeps)
    if emit_links:
        total += ((nb - 1) * 120                  # FK
                  + 15 + 30 * (n - 6)             # spatial velocities
                  + meta.n_links * 130)           # link poses, velocities
    return total


def megastep_bytes(meta: MegaMeta, batch: int, substeps: Optional[int] = None,
                   emit_links: bool = False) -> int:
    """Bytes the function must move for ``batch`` envs: the state and
    targets read once; the state, flags, base history (and the link rows)
    written once; the static tables."""
    substeps = meta.frame_skip if substeps is None else substeps
    per_env = (meta.rows_state + 4 * meta.n_sph + meta.n_rev          # in
               + meta.rows_state + meta.n_cand + 3 * substeps)        # out
    if emit_links:
        per_env += LINK_ROWS * meta.n_links
    return 4 * batch * per_env + ctypes.sizeof(MegaTables)


# ---------------------------------------------------------------------------
# building and loading the kernel
# ---------------------------------------------------------------------------

def _declare(lib, host: bool):
    ptrs = [ctypes.c_void_p] * 8
    if host:
        fn = lib.pfpn_megastep_host
        fn.argtypes = ptrs + [ctypes.c_int] * 3
    else:
        fn = lib.pfpn_megastep_launch
        fn.argtypes = ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pfpn_megastep_tables_bytes.argtypes = []
    lib.pfpn_megastep_tables_bytes.restype = ctypes.c_int
    lib.pfpn_megastep_shared_bytes.argtypes = [ctypes.c_void_p]
    lib.pfpn_megastep_shared_bytes.restype = ctypes.c_int
    lib.pfpn_megastep_default_threads.argtypes = []
    lib.pfpn_megastep_default_threads.restype = ctypes.c_int
    if lib.pfpn_megastep_tables_bytes() != ctypes.sizeof(MegaTables):
        raise RuntimeError("MegaTables layout differs between "
                           "csrc/megastep.cu and ops/megastep.py")


LIBRARY = CudaSource("megastep", _declare, headers=("block_linalg.cuh",))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

class Megastep:
    """One control step for a batch of envs: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors.

    ``reference_substep(state, t_sph, t_rev) -> (state', active_all,
    base_pos)`` is the engine's batched fused substep (the plain version's
    body). With ``links=True`` a call runs the ``emit_links`` variant and
    also returns the final link states, as ``make_megastep(...,
    link_state_fn)`` does; its plain version takes them from
    ``link_state_fn(state') -> LinkStates``. ``launches`` and
    ``launches_links`` count the kernel launches of the two variants."""

    def __init__(self, meta: MegaMeta, reference_substep: Callable,
                 link_state_fn: Callable):
        self.meta = meta
        self.reference_substep = reference_substep
        self.link_state_fn = link_state_fn
        self.tables = pack_tables(meta)
        self._tables_dev = {}
        self._shared_bytes = None
        self.launches = 0
        self.launches_links = 0

    # -- SimState interface (Engine.control_step_full / control_step_links) --
    def __call__(self, state, t_sph: torch.Tensor, t_rev: torch.Tensor,
                 links: bool = False):
        """(state', active (B, n_cand) bool, base_hist (B, frame_skip, 3)),
        and the final LinkStates with ``links``."""
        B = t_sph.shape[0]
        st = pack_state(self.meta, state)
        out = self.run(st, t_sph.reshape(B, -1), t_rev, links=links)
        sim = unpack_state(self.meta, out[0], state)
        if links:
            return sim, out[1], out[2], links_to_states(self.meta, out[3])
        return (sim,) + out[1:]

    def run(self, st, tgt_sph, tgt_rev, substeps: Optional[int] = None,
            links: bool = False, out=None):
        """Packed interface: st (B, rows_state), tgt_sph (B, 4 n_sph),
        tgt_rev (B, n_rev) -> (st', active bool, hist (B, substeps, 3)),
        plus the link rows (B, LINK_ROWS * n_links) with ``links``. With
        ``out``, buffers as :meth:`outputs` makes them, the raw results
        (the flags as 0/1 floats) go there and nothing is returned."""
        if st.is_cuda:
            return self.kernel(st, tgt_sph, tgt_rev, substeps, links=links, out=out)
        res = self.plain(st, tgt_sph, tgt_rev, substeps, links=links)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return None

    def _check(self, st, tgt_sph, tgt_rev, substeps) -> int:
        """Raise on inputs no version takes; returns the substep count
        (``frame_skip`` by default)."""
        m = self.meta
        substeps = m.frame_skip if substeps is None else int(substeps)
        B = st.shape[0]
        want = {"st": (st, (B, m.rows_state)),
                "tgt_sph": (tgt_sph, (B, 4 * m.n_sph)),
                "tgt_rev": (tgt_rev, (B, m.n_rev))}
        for name, (x, shape) in want.items():
            if tuple(x.shape) != shape:
                raise ValueError(f"megastep {name}: shape {tuple(x.shape)}, "
                                 f"want {shape}")
            if x.dtype != torch.float32:
                raise TypeError(f"megastep {name}: dtype {x.dtype}, want float32")
            if x.device != st.device:
                raise ValueError(f"megastep {name} on {x.device}, st on {st.device}")
        if B < 1 or substeps < 1:
            raise ValueError("megastep needs B >= 1 and substeps >= 1")
        return substeps

    def shared_bytes(self, lib) -> int:
        """Dynamic shared memory of one block, as the CUDA source lays it out."""
        if self._shared_bytes is None:
            self._shared_bytes = int(lib.pfpn_megastep_shared_bytes(
                ctypes.addressof(self.tables)))
        return self._shared_bytes

    def outputs(self, B: int, substeps: int, dev, links: bool):
        """Empty (st', act, hist, link rows or None) buffers of one launch."""
        m = self.meta
        st_out = torch.empty(B, m.rows_state, device=dev)
        act = torch.empty(B, m.n_cand, device=dev)
        hist = torch.empty(B, substeps, 3, device=dev)
        rows = torch.empty(B, LINK_ROWS * m.n_links, device=dev) if links else None
        return st_out, act, hist, rows

    @staticmethod
    def result(st_out, act, hist, rows):
        """The raw buffers of one launch as :meth:`run` returns them."""
        out = (st_out, act > 0.5, hist)
        return out if rows is None else out + (rows,)

    # -- the kernel ---------------------------------------------------------
    def kernel(self, st, tgt_sph, tgt_rev, substeps: Optional[int] = None,
               links: bool = False, threads: Optional[int] = None, out=None):
        """Launch csrc/megastep.cu, one block per env; ``threads`` per block
        (a multiple of 32, at most 256; None for the source's default).
        With ``out`` (buffers as :meth:`outputs` makes them) the kernel
        writes there and nothing is returned."""
        substeps = self._check(st, tgt_sph, tgt_rev, substeps)
        if not st.is_cuda:
            raise ValueError("megastep kernel needs CUDA tensors")
        for name, x in (("st", st), ("tgt_sph", tgt_sph), ("tgt_rev", tgt_rev)):
            if not x.is_contiguous():
                raise ValueError(f"megastep {name} must be contiguous")
        lib = LIBRARY.load()
        dev = st.device
        tables = self._tables_dev.get(dev)
        if tables is None:
            raw = torch.frombuffer(bytearray(bytes(self.tables)), dtype=torch.uint8)
            tables = raw.to(dev)
            self._tables_dev[dev] = tables
        B = st.shape[0]
        st_out, act, hist, rows = out or self.outputs(B, substeps, dev, links)
        with torch.cuda.device(dev):     # the launch goes to the current device
            rc = lib.pfpn_megastep_launch(
                tables.data_ptr(), st.data_ptr(), tgt_sph.data_ptr(),
                tgt_rev.data_ptr(), st_out.data_ptr(), act.data_ptr(),
                hist.data_ptr(), None if rows is None else rows.data_ptr(),
                B, substeps, threads or 0, self.shared_bytes(lib),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"megastep kernel launch failed: cudaError {rc}")
        if links:
            self.launches_links += 1
        else:
            self.launches += 1
        return None if out else self.result(st_out, act, hist, rows)

    # -- the CUDA source's arithmetic on the host ---------------------------
    def host(self, st, tgt_sph, tgt_rev, substeps: Optional[int] = None,
             links: bool = False, threads: int = 1):
        """Run csrc/megastep.cu's block body, built with g++, on CPU tensors
        with ``threads`` host threads per env (the CPU tests' view of the
        kernel's arithmetic)."""
        substeps = self._check(st, tgt_sph, tgt_rev, substeps)
        st, tgt_sph, tgt_rev = (x.detach().cpu().contiguous()
                                for x in (st, tgt_sph, tgt_rev))
        lib = LIBRARY.load(host=True)
        B = st.shape[0]
        st_out, act, hist, rows = self.outputs(B, substeps, "cpu", links)
        rc = lib.pfpn_megastep_host(
            ctypes.addressof(self.tables), st.data_ptr(), tgt_sph.data_ptr(),
            tgt_rev.data_ptr(), st_out.data_ptr(), act.data_ptr(),
            hist.data_ptr(), None if rows is None else rows.data_ptr(),
            B, substeps, int(threads))
        if rc != 0:
            raise ValueError(f"megastep host build: threads={threads} refused")
        return self.result(st_out, act, hist, rows)

    # -- the plain version ----------------------------------------------------
    def plain(self, st, tgt_sph, tgt_rev, substeps: Optional[int] = None,
              links: bool = False):
        """Loop of reference substeps (make_megastep._primal), then, with
        ``links``, ``link_state_fn`` of the final state."""
        from ..sim.types import SimState

        m = self.meta
        substeps = self._check(st, tgt_sph, tgt_rev, substeps)
        B = st.shape[0]
        template = SimState(*([None] * 8))
        state = unpack_state(m, st, template)
        t_sph = tgt_sph.reshape(B, m.n_sph, 4)
        hist, act = [], None
        for _ in range(substeps):
            state, act, base_pos = self.reference_substep(state, t_sph, tgt_rev)
            hist.append(base_pos)
        out = (pack_state(m, state), act, torch.stack(hist, 1))
        if links:
            out += (states_to_links(self.link_state_fn(state)),)
        return out
