"""One run of one cell: set-up, the measured window, the check, one result line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. The cell, its configuration file, its traffic file, its
per-layer readers and its limits are found by name from ``BENCHMARK.json``:

* ``configs/<config>.json``: the model, env and algorithm as run;
* ``traffic/<traffic>.json``: the loop (``loops/<loop>.py``) and its
  parameters (envs, warm-up, what the check samples, the traced stretch);
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``limits/<cell>.json``: the limit of each number the check compares.

The run exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for), when the port cannot be imported, or when
JAX, its libraries or the JAX package are loaded once the window has
closed. Otherwise its last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number with
its limit, also printed as the last lines on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pfpn_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    metrics and limits, found by name."""

    def __init__(self, name: str, spec: Optional[Dict] = None,
                 traffic: Optional[Dict] = None):
        spec = spec if spec is not None else load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.spec, self.entry = name, spec, cells[name]
        cfg_entry = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = load_json(os.path.join(ROOT, cfg_entry["file"]))
        self.traffic = traffic if traffic is not None else load_json(
            os.path.join(HERE, "traffic", f"{self.entry['traffic']}.json"))
        self.limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
        self.chips = int(self.entry["chips"])

    def _mine(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def end_to_end(self) -> List[Dict]:
        return [m for m in self.spec["end_to_end"] if self._mine(m)]

    @property
    def per_layer(self) -> List[Dict]:
        return [m for m in self.spec["per_layer"] if self._mine(m)]


def reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read``, or that of the part of the name
    before the first dot."""
    exact = os.path.join(HERE, "metrics", f"{metric}.py")
    if os.path.exists(exact):
        mod_name = "portbench.metrics._" + metric.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, exact)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod.read
    return importlib.import_module(f"portbench.metrics.{metric.split('.')[0]}").read


class ReaderContext:
    """What a per-layer reader reads: the traced stretch (``trace``), the
    benchmark's spans in ms (``spans``), the measured window's totals
    (``window``: steps or rounds, seconds, frozen operations), the frozen
    counts (``counts``) and the card's peaks (``peaks``)."""

    def __init__(self, trace, spans, window, counts, peaks):
        self.trace, self.spans, self.window = trace, spans, window
        self.counts, self.peaks = counts, peaks


class Run:
    """One run's parameters for a loop (``loops/<loop>.py``), whose ``run``
    returns a dict: ``e2e`` (end-to-end values), ``window`` (its totals),
    ``trace``, ``spans``, ``counts``, ``records`` and ``updates`` (what the
    check judges). ``hooks`` lets a test reach the built program
    (``hook("built", ...)``)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float, hooks: Optional[Dict[str, Callable]] = None):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.t_start, self.hooks = t_start, hooks or {}
        self.setup_s: Optional[float] = None

    def hook(self, name: str, **kw) -> None:
        if name in self.hooks:
            self.hooks[name](**kw)

    def setup_done(self) -> None:
        self.setup_s = time.time() - self.t_start

    def mark(self, what: str) -> None:
        """A set-up milestone on standard error, in seconds since the start."""
        self.note(f"{what} at {time.time() - self.t_start:.3f} s")

    def note(self, text: str) -> None:
        print(f"portbench: {text}", file=sys.stderr, flush=True)


def reference_net(cfg: Dict, device, state: Optional[Dict] = None):
    """The reference actor-critic of ``cfg``, with the configuration's
    ``.npz`` weights read by the reference's own loader, or ``state``."""
    import numpy as np

    from .reference.policy import ActorCritic, state_dict_from_npz

    net = ActorCritic(cfg["obs_dim"], cfg["action_dim"], cfg["particles"],
                      cfg["actor_shape"], cfg["critic_shape"], cfg["clip_state"]).to(device)
    if state is None:
        with np.load(os.path.join(ROOT, cfg["weights"])) as z:
            state = state_dict_from_npz({k: z[k] for k in z.files})
    net.load_state_dict({k: v.to(device) for k, v in state.items()})
    return net


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def check(cell: Cell, out: Dict, device) -> Dict[str, float]:
    """The numbers the limits hold: the reference, in float32 with TF32
    off, judging what the port produced; in training after following the
    port's first updates, each step record with the weights of its round."""
    from . import judge
    from .reference import env as ref_env_mod

    set_tf32(False)
    ref_env = ref_env_mod.make(cell.config["env"], device=device)
    readings = []

    def judge_round(k, net):
        for kk, rec in out["records"]:
            if kk == k:
                rec = rec.to(device)
                policy = judge.judge_policy(rec, net)
                if k:   # after an update: the weights differ by round-off
                    print(f"portbench: policy gaps in round {k + 1}, not compared: "
                          f"{policy}", file=sys.stderr)
                    policy = {}
                readings.append({**policy, **judge.judge_env(rec, ref_env)})

    upd = out["updates"]
    if upd is None:
        judge_round(None, reference_net(cell.config, device))
        return judge.combine(readings)
    losses, grad1, params = _ref_updates(cell, upd, device, judge_round)
    left_out = sorted(set(grad1) - set(judge.moving_leaves(grad1)))
    print(f"portbench: leaves left out of the change (reference gradient under 1e-3 "
          f"of the median leaf's): {left_out}", file=sys.stderr)
    w0 = {k: v.to(device) for k, v in upd["w0"].items()}
    got_change = {n: upd["params3"][n].to(device) - w0[n] for n in upd["names"]}
    want_change = {n: params[n] - w0[n] for n in upd["names"]}
    readings.append(judge.judge_updates(
        upd["losses"], losses, {n: g.to(device) for n, g in upd["grad1"].items()},
        grad1, got_change, want_change))
    return judge.combine(readings)


def _ref_updates(cell: Cell, upd: Dict, device, judge_round=None, half: bool = False):
    """The reference's three updates from ``w0`` on the port's rollouts:
    (losses, the first clipped gradients, the parameters after the last);
    ``judge_round(k, net)`` runs before update k. ``half`` plants a fault:
    each update over the first half of the envs only."""
    from .reference.a2c import A2CReference, A2CSettings

    cfg = cell.config
    net = reference_net(cfg, device, upd["w0"])
    ref = A2CReference(net, A2CSettings(
        gamma=cfg["gamma"], lambd=cfg["lambd"], value_loss_coef=cfg["value_loss_coef"],
        entropy_beta=cfg["entropy_beta"], lr=cfg["lr_actor"], norm_clip=cfg["norm_clip"]))
    losses, grad1 = [], None
    for k, traj in enumerate(upd["rounds"]):
        if judge_round is not None:
            judge_round(k, net)
        if half:
            traj = {key: v[:, :v.shape[1] // 2] for key, v in traj.items()}
        loss, grads = ref.update({key: v.to(device) for key, v in traj.items()})
        losses.append(loss)
        if k == 0:
            grad1 = grads
    params = {n: p.detach().clone() for n, p in net.named_parameters()}
    return losses, grad1, params


def control(cell: Cell, out: Dict, device) -> Dict[str, float]:
    """The numbers the reference gives when computed with TF32 on, in the
    port's place, judged by the reference with TF32 off (a card only: TF32
    is an NVIDIA matmul mode)."""
    from .reference import env as ref_env_mod

    upd = out["updates"]
    set_tf32(True)
    try:
        low_env = ref_env_mod.make(cell.config["env"], device=device)
        if upd is None:
            nets, low_upd = {None: reference_net(cell.config, device)}, None
        else:
            snaps = {}

            def keep(k, net):
                snaps[k] = {n: p.detach().clone() for n, p in net.state_dict().items()}

            losses, grad1, params = _ref_updates(cell, upd, device, keep)
            nets = {k: reference_net(cell.config, device, s) for k, s in snaps.items()}
            low_upd = dict(upd, losses=losses, grad1=grad1, params3=params)
        records = [(k, _low_record(rec.to(device), low_env, nets[k]))
                   for k, rec in out["records"]]
    finally:
        set_tf32(False)
    return check(cell, {"records": records, "updates": low_upd}, device)


def faults(cell: Cell, out: Dict, device) -> Dict[str, Dict[str, float]]:
    """The numbers of faults planted in what the port produced or in the
    reference put in its place: every reward 0.1% off where it is produced;
    in training also an optimizer step that leaves the state unchanged and
    updates over half the batch, the mean taken over the rest."""
    import torch

    readings = {}
    upd = out["updates"]
    recs = [(k, dataclasses.replace(rec, reward=rec.reward * 1.001))
            for k, rec in out["records"]]
    readings["altered_reward"] = check(cell, {"records": recs, "updates": upd}, device)
    if upd is not None:
        same = dict(upd, params3={n: upd["w0"][n] for n in upd["names"]},
                    grad1={n: torch.zeros_like(g) for n, g in upd["grad1"].items()})
        readings["state_unchanged"] = check(cell, {"records": out["records"],
                                                   "updates": same}, device)
        losses, grad1, params = _ref_updates(cell, upd, device, half=True)
        readings["half_batch"] = check(cell, {"records": out["records"], "updates": dict(
            upd, losses=losses, grad1=grad1, params3=params)}, device)
    return readings


def _policy_of(rec, net) -> Dict:
    import torch

    with torch.no_grad():
        return {"log_prob": net.log_prob(rec.obs, rec.action), "value": net.value(rec.obs)}


def _low_record(rec, low_env, net):
    """``rec`` with the port's outputs replaced by the reference's, as
    computed under the current precision settings."""
    import torch

    from . import judge

    with torch.no_grad():
        res = low_env.step(judge.ref_state(rec.pre), rec.clipped)
        post = judge.flat_state(res.state)
        done = res.done
        new_state = {k: v.clone() for k, v in post.items()}
        new_obs = res.obs.clone()
        if done.any():
            dur = float(low_env.motion.duration)
            t0 = torch.where(rec.done, rec.new_state["init_time"],
                             torch.full_like(rec.new_state["init_time"], 0.5 * dur))[done]
            st, o = low_env.reset_at(t0)
            for k, v in judge.flat_state(st).items():
                new_state[k][done] = v
            new_obs[done] = o
    return dataclasses.replace(
        rec, post=post, res_obs=res.obs, reward=res.reward, done=done,
        terminated=res.terminated, truncated=res.truncated, new_state=new_state,
        new_obs=new_obs, **_policy_of(rec, net))


def device_info(device) -> Dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_line() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except Exception as exc:     # the line is a note; the run goes on
        return f"nvidia-smi unavailable ({exc})"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             t_start: Optional[float] = None, hooks=None, spec=None,
             traffic: Optional[Dict] = None, with_control: bool = False,
             with_faults: bool = False) -> Dict:
    """Set up, measure, check. Returns the result object, with the
    control's numbers under ``"control"`` and the planted faults' under
    ``"faults"`` when asked (``calibrate.py``)."""
    import torch

    from . import judge

    cell = Cell(name, spec, traffic)
    device = torch.device(device or "cuda")
    set_tf32(False)
    r = Run(cell, seed, seconds, trace, device,
            time.time() if t_start is None else t_start, hooks)
    loop = importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")
    out = loop.run(r)
    dev_info = device_info(device)
    if trace and device.type == "cuda":
        t = out["trace"]
        dev_info["busy_s"] = t.busy_us / 1e6
        dev_info["window_s"] = t.window_us / 1e6
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check(cell, out, device)
    correct, checks = judge.verdict(numbers, cell.limits)
    w = out["window"]
    attempted = int(w.get("steps", w.get("rounds", 0)))
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": 0 if correct else attempted}
    peaks = load_json(os.path.join(HERE, "counts", "peaks.json"))
    if trace:
        ctx = ReaderContext(out["trace"], out["spans"], out["window"], out["counts"], peaks)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        values = dict(out["e2e"], setup_s=r.setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = dev_info
    if trace and out["trace"] is not None:
        result["breakdown"] = out["trace"].breakdown()
    if with_control:
        result["control"] = control(cell, out, device)
    if with_faults:
        result["faults"] = faults(cell, out, device)
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = time.time() if t_start is None else t_start

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: torch imported at {time.time() - t_start:.3f} s", file=sys.stderr)
    import pfpn_torch  # noqa: F401  (fails here, with no result, without the port)

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
