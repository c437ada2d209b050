"""Time the port's kernels of one tree of this repository on the card.

    python pfpn_torch/tools/bench_megastep.py [--root DIR] [--groups 5]
        [--kernels megastep,spd_inverse,substep_lin]

Imports ``pfpn_torch`` from ``DIR`` (by default the checkout that holds
this file), builds the named kernels from its ``csrc/`` and times them, each
as the median of ``--groups`` groups of CUDA-event-timed launches taken in
turns, with their range:

* ``megastep``: both variants (the default and ``emit_links``) at B = 8
  (the training batch) and B = 8192 (the throughput batch), from perturbed
  reset states with identity targets;
* ``spd_inverse``: ``spd_inverse_pair`` on 16,384 matrices and
  ``spd_inverse`` on 8,192, (H + diag(kd dt) + eps, H + eps) of perturbed
  reset states at B = 8192 (``chip_smoke.py`` phase 6's inputs);
* ``substep_lin``: ``substep_core`` at B = 8192 on drop states in ground
  contact under identity targets (phase 7's inputs).

Prints one JSON line with the card's name and power limit. To compare two
trees on one card, run it for each in turns (A, B, B, A) on one machine;
trees from before the two megastep variants shared one ``Megastep``
(``Engine.mega_links``) are timed through their own API.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--groups", type=int, default=5)
    ap.add_argument("--kernels", default="megastep",
                    help="comma-separated: megastep, spd_inverse, substep_lin")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    unknown = set(kernels) - {"megastep", "spd_inverse", "substep_lin"}
    if unknown:
        raise SystemExit(f"bench_megastep: unknown kernels {sorted(unknown)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["PFPN_MEGASTEP_LINKS"] = "1"   # older trees build their links variant only then

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_megastep: no CUDA card")
    from pfpn_torch.control.spd import spd_errors
    from pfpn_torch.envs.deepmimic import make
    from pfpn_torch.ops import linalg
    from pfpn_torch.ops import megastep as ms
    from pfpn_torch.ops import substep_lin as sl
    from pfpn_torch.sim import contact as contact_mod
    from pfpn_torch.sim.types import zero_state

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    env = make("DeepMimicWalk-v0", device=dev)
    eng, meta, tree = env.engine, env.engine.meta, env.tree

    def cuda_ms(fn, reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def in_turns(fns, reps):
        """{name: [median, min, max]} of the groups, the functions in turns."""
        for fn in fns.values():
            fn()
        times = {k: [] for k in fns}
        for _ in range(args.groups):
            for k, fn in fns.items():
                times[k].append(cuda_ms(fn, reps))
        return {k: [sorted(v)[len(v) // 2], min(v), max(v)] for k, v in times.items()}

    def perturbed_sim(B, seed):
        """Reset states with velocities perturbed so contacts and limits
        engage (tests/test_megastep.py:108-118)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        sim = env.reset_batch(B, g)[0].sim
        return sim.replace(
            base_lin=sim.base_lin + torch.tensor([0.1, -0.4, 0.0], device=dev),
            w_sph=sim.w_sph + 0.3 * torch.randn(sim.w_sph.shape, generator=g, device=dev),
            w_rev=sim.w_rev + 0.3 * torch.randn(sim.w_rev.shape, generator=g, device=dev))

    def drop_sim(B, seed):
        """Falling states touching the ground (tests/test_fused.py:26-40)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        sim = zero_state(tree, B, device=dev)
        sim.base_pos[:] = torch.tensor([0.0, 0.878, 0.0], device=dev)
        sim.base_lin[:] = torch.tensor([0.1, -0.5, 0.05], device=dev)
        return sim.replace(
            base_ang=0.1 * torch.randn(B, 3, generator=g, device=dev),
            w_sph=0.2 * torch.randn(sim.w_sph.shape, generator=g, device=dev),
            w_rev=0.2 * torch.randn(sim.w_rev.shape, generator=g, device=dev))

    result = {"root": root, "card": card}
    if "megastep" in kernels:
        ms.LIBRARY.load()
        if getattr(eng, "mega_links", None) is not None:      # one Megastep per variant
            variants = {"default": eng.mega.kernel, "emit_links": eng.mega_links.kernel}
        else:
            variants = {"default": eng.mega.kernel,
                        "emit_links": lambda *a: eng.mega.kernel(*a, links=True)}
        for B, reps in ((8, 10), (8192, 2)):
            st = ms.pack_state(meta, perturbed_sim(B, 5)).contiguous()
            ts = torch.zeros(B, meta.n_sph, 4, device=dev)
            ts[..., 3] = 1.0
            ts = ts.reshape(B, -1)
            tr = torch.zeros(B, meta.n_rev, device=dev)
            fns = {k: (lambda f=f: f(st, ts, tr)) for k, f in variants.items()}
            for k, t in in_turns(fns, reps).items():
                result[f"B{B}_{k}_ms"] = t

    kd_t = torch.tensor(eng.gains.kd, dtype=torch.float32, device=dev)
    kp_t = torch.tensor(eng.gains.kp, dtype=torch.float32, device=dev)
    if "spd_inverse" in kernels:
        linalg.LIBRARY.load()
        h = eng._dynamics(perturbed_sim(8192, 9))[1]
        eye = torch.eye(tree.ndof, device=dev)
        pairs = torch.stack([h + torch.diag(kd_t * eng.config.dt) + 1e-8 * eye,
                             h + 1e-8 * eye], 1).contiguous()
        single = pairs[:, 1].contiguous()
        t = in_turns({"pair": lambda: linalg.spd_inverse_kernel(pairs),
                      "single": lambda: linalg.spd_inverse_kernel(single)}, 20)
        result["spd_inverse_pair_16384_ms"] = t["pair"]
        result["spd_inverse_8192_ms"] = t["single"]
        del pairs, single, h
    if "substep_lin" in kernels:
        sl.LIBRARY.load()
        sim = drop_sim(8192, 11)
        fkr, h, c, v = eng._dynamics(sim)
        ts = torch.zeros(8192, meta.n_sph, 4, device=dev)
        ts[..., 3] = 1.0
        tr = torch.zeros(8192, meta.n_rev, device=dev)
        e_p, e_dp = spd_errors(tree, eng.gains, sim, ts, tr, eng.config.dt)
        kpe = kp_t * e_p + kd_t * e_dp
        rs = contact_mod.assemble_rows(tree, eng.contact_set, eng.config.contact, fkr,
                                       sim.q_rev, eng.config.dt)
        core = (h, kpe - c, kpe, v, rs.rows, rs.target, rs.act_n, rs.act_l)
        smeta = eng.substep_meta
        t = in_turns({"core": lambda: sl.substep_core_kernel(smeta, *core)}, 20)
        result["substep_core_8192_ms"] = t["core"]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
