"""Time the megastep kernel of one tree of this repository on the card.

    python pfpn_torch/tools/bench_megastep.py [--root DIR] [--groups 5]

Imports ``pfpn_torch`` from ``DIR`` (by default the checkout that holds
this file), builds its ``csrc/megastep.cu`` and times both variants (the
default and ``emit_links``) at B = 8 (the training batch) and B = 8192 (the
throughput batch) from perturbed reset states with identity targets, each
as the median of ``--groups`` groups of CUDA-event-timed launches taken in
turns, with their range. Prints one JSON line with the card's name and
power limit. To compare two trees on one card, run it for each in turns
(A, B, B, A) in one session; trees from before the two variants shared one
``Megastep`` (``Engine.mega_links``) are timed through their own API.
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
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["PFPN_MEGASTEP_LINKS"] = "1"   # older trees build their links variant only then

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_megastep: no CUDA card")
    from pfpn_torch.envs.deepmimic import make
    from pfpn_torch.ops import megastep as ms

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    ms.LIBRARY.load()
    env = make("DeepMimicWalk-v0", device=dev)
    eng, meta = env.engine, env.engine.meta
    if getattr(eng, "mega_links", None) is not None:      # one Megastep per variant
        variants = {"default": eng.mega.kernel, "emit_links": eng.mega_links.kernel}
    else:
        variants = {"default": eng.mega.kernel,
                    "emit_links": lambda *a: eng.mega.kernel(*a, links=True)}

    def cuda_ms(fn, reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    result = {"root": root, "card": card}
    for B, reps in ((8, 10), (8192, 2)):
        g = torch.Generator(device=dev).manual_seed(5)
        sim = env.reset_batch(B, g)[0].sim
        sim = sim.replace(
            base_lin=sim.base_lin + torch.tensor([0.1, -0.4, 0.0], device=dev),
            w_sph=sim.w_sph + 0.3 * torch.randn(sim.w_sph.shape, generator=g, device=dev),
            w_rev=sim.w_rev + 0.3 * torch.randn(sim.w_rev.shape, generator=g, device=dev))
        st = ms.pack_state(meta, sim).contiguous()
        ts = torch.zeros(B, meta.n_sph, 4, device=dev)
        ts[..., 3] = 1.0
        ts = ts.reshape(B, -1)
        tr = torch.zeros(B, meta.n_rev, device=dev)
        fns = {k: (lambda f=f: f(st, ts, tr)) for k, f in variants.items()}
        for fn in fns.values():
            fn()
        times = {k: [] for k in fns}
        for _ in range(args.groups):
            for k, fn in fns.items():
                times[k].append(cuda_ms(fn, reps))
        for k, v in times.items():
            v = sorted(v)
            result[f"B{B}_{k}_ms"] = [v[len(v) // 2], v[0], v[-1]]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
