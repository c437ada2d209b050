"""Operations and bytes of one 30 Hz control step, frozen.

A copy of ``megastep_flops`` and ``megastep_bytes`` of
``pfpn_torch/ops/megastep.py`` as they stand when the benchmark was
written, fed from the reference's own kinematic tree and contact set, so
that the work a control step needs reads the same whatever implements it.
An FMA counts two; sqrt, division and the transcendentals count one; the
two SPD inverses count as a Cholesky factor and one solve each. For the
humanoid: 7,747,740 operations per env (63.5 GFLOP at B = 8192), 7,751,985
with the link-state epilogue; 9.41 MB moved at B = 8192.
"""

from __future__ import annotations

import types

from ..reference.types import REVOLUTE

# bytes of the kernel's static tables (sizeof(MegaTables) in
# csrc/megastep.cu at the time of freezing)
TABLE_BYTES = 6380
# rows of one link's state in the emit_links output
LINK_ROWS = 20


def meta_of(env) -> types.SimpleNamespace:
    """The sizes the counts read, from a reference env
    (``portbench/reference/env.py``)."""
    tree, cs, cfg = env.tree, env.engine.contact_set, env.engine.config
    n_cand = int(cs.body.shape[0])
    k = cfg.contact.max_contacts
    k = n_cand if (k is None or k >= n_cand) else int(k)
    sph_m, rev_m = [], []
    for b in tree.motor_bodies:
        (rev_m if int(tree.joint_type[b]) == REVOLUTE else sph_m).append(int(b))
    n_lim = int(cs.limit_dof.shape[0])
    return types.SimpleNamespace(
        ndof=tree.ndof, nb=tree.nb, n_sph=tree.n_sph, n_rev=tree.n_rev,
        n_cand=n_cand, n_contacts=k, n_lim=n_lim, n_rows=3 * k + n_lim,
        iterations=cfg.contact.iterations, frame_skip=cfg.frame_skip,
        parent=tuple(int(x) for x in tree.parent),
        dof_body=tuple(int(x) for x in cs.dof_body),
        n_sph_motors=len(sph_m), n_rev_motors=len(rev_m),
        n_links=len(tree.link_body),
        rows_state=13 + 7 * tree.n_sph + 2 * tree.n_rev)


def flops_per_env(meta, emit_links: bool = False) -> int:
    """fp32 operations one env's control step needs."""
    n, K, nb, C = meta.ndof, meta.n_contacts, meta.nb, meta.n_cand
    K3, R, it, L = 3 * K, meta.n_rows, meta.iterations, meta.n_lim
    pairs = 0                                  # ancestor-or-self dof pairs
    for e in range(n):
        chain, j = set(), meta.dof_body[e]
        while j >= 0:
            chain.add(j)
            j = meta.parent[j]
        pairs += sum(1 for d in range(e + 1) if meta.dof_body[d] in chain)
    n_sph_m, n_rev_m = meta.n_sph_motors, meta.n_rev_motors
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
        + 25 * C + K * (C + 12 * n)               # candidates, top-K rows
        + 2 * n * n * K3 + n * L                  # W
        + (K3 * (K3 + 1) // 2) * (2 * n + 3)      # |A| row sums
        + L * (K3 + R) * 2 + 3 * R                # limit sums, step
        + K3 * 2 * n + L                          # b = J v*
        + it * (2 * n * R + K3 * 2 * n + 11 * R)  # Jacobi sweeps
        + 2 * n * R + 2 * n                       # v* + W lam, clip
        + 80 + 60 * meta.n_sph + 6 * meta.n_rev)  # integration
    total = per_sub * meta.frame_skip
    if emit_links:
        total += ((nb - 1) * 120                  # FK
                  + 15 + 30 * (n - 6)             # spatial velocities
                  + meta.n_links * 130)           # link poses, velocities
    return total


def bytes_per_launch(meta, batch: int, emit_links: bool = False) -> int:
    """Bytes one launch must move for ``batch`` envs: the state and targets
    read once; the state, flags and base history (and the link rows)
    written once; the static tables."""
    per_env = (meta.rows_state + 4 * meta.n_sph + meta.n_rev
               + meta.rows_state + meta.n_cand + 3 * meta.frame_skip)
    if emit_links:
        per_env += LINK_ROWS * meta.n_links
    return 4 * batch * per_env + TABLE_BYTES
