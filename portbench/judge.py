"""Whether what the timed path produced is correct, by the plain reference.

Each check starts from a state the timed path produced, at the start of one
control step (over 20 contact-rich substeps a 1e-7 difference can flip a
knife-edge contact), on rows of the batch drawn from the seed:

* the policy: the log-prob and value of the actions the port drew, on the
  port's observations, by the reference network (in training on a step of
  the first round, whose weights both sides share exactly: after an Adam
  step the two sides' weights differ by round-off);
* the physics: one control step of the reference from the port's pre-step
  state and clipped action; an env is out when a state group leaves its
  bound (the bounds of ``chip_smoke.py``'s control-step check) or its
  termination differs, and the share of envs out is compared;
* observation and reward: the reference's, of the port's post-step state
  (with ``emit_links`` this holds the kernel's link states);
* bookkeeping, exactly: time, truncation, done, and the untouched envs;
* auto-reset: the reference's reset at the port's drawn start times;
* training: the reference follows the port's first three updates from the
  same weights and the port's rollouts, and the loss of each, the first
  clipped gradient (from the port's Adam state after one step) and the
  parameters' change after three steps are compared leaf by leaf.

A number's value is a gap or a share; its limit is in ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from .reference import env as ref_env_mod
from .reference.types import SimState

SIM_FIELDS = ("base_pos", "base_quat", "base_lin", "base_ang", "q_sph", "w_sph",
              "q_rev", "w_rev")
# per-group bounds of one control step (chip_smoke.py's tol20, with the
# velocities it does not bound held as w_sph is)
STEP_BOUNDS = {"base_pos": 2e-4, "base_quat": 2e-4, "q_sph": 2e-4, "q_rev": 2e-4,
               "ref_pos_offset": 2e-4, "base_lin": 5e-3, "base_ang": 5e-3,
               "w_sph": 5e-3, "w_rev": 5e-3}


def flat_state(st, rows: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """An env state (the port's or the reference's) as a dict of tensors,
    the given rows only, detached copies."""
    out = {f: getattr(st.sim, f) for f in SIM_FIELDS}
    out.update(elapsed_time=st.elapsed_time, init_time=st.init_time,
               ref_pos_offset=st.ref_pos_offset)
    return {k: (v if rows is None else v[rows]).detach().clone() for k, v in out.items()}


def ref_state(d: Dict[str, torch.Tensor]):
    return ref_env_mod.EnvState(sim=SimState(**{f: d[f] for f in SIM_FIELDS}),
                                elapsed_time=d["elapsed_time"], init_time=d["init_time"],
                                ref_pos_offset=d["ref_pos_offset"])


@dataclasses.dataclass
class StepRecord:
    """One env step of the timed path on the checked rows: its inputs (pre,
    obs, action, clipped) and the port's outputs."""

    pre: Dict[str, torch.Tensor]
    obs: torch.Tensor
    action: torch.Tensor
    clipped: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    post: Dict[str, torch.Tensor]
    res_obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    new_state: Dict[str, torch.Tensor]
    new_obs: torch.Tensor

    def to(self, device) -> "StepRecord":
        def mv(x):
            if isinstance(x, dict):
                return {k: v.to(device) for k, v in x.items()}
            return x.to(device)
        return StepRecord(**{f.name: mv(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def record(rows, pre, obs, action, clipped, log_prob, value, res, new_state,
           new_obs) -> StepRecord:
    """A :class:`StepRecord` of ``rows`` from one step's full tensors (``res``
    is the port's StepResult)."""
    return StepRecord(
        pre=flat_state(pre, rows), obs=obs[rows].clone(), action=action[rows].clone(),
        clipped=clipped[rows].clone(), log_prob=log_prob[rows].clone(),
        value=value[rows].clone(), post=flat_state(res.state, rows),
        res_obs=res.obs[rows].clone(), reward=res.reward[rows].clone(),
        done=res.done[rows].clone(), terminated=res.terminated[rows].clone(),
        truncated=res.truncated[rows].clone(), new_state=flat_state(new_state, rows),
        new_obs=new_obs[rows].clone())


def check_rows(batch: int, n: int, done: torch.Tensor, generator: torch.Generator,
               n_done: int = 64) -> torch.Tensor:
    """``n`` rows drawn from ``generator`` and up to ``n_done`` of the rows
    that finished their episode, sorted (on ``done``'s device)."""
    pick = torch.randperm(batch, generator=generator)[:min(n, batch)]
    fin = torch.nonzero(done.cpu(), as_tuple=False)[:, 0]
    if fin.numel():
        fin = fin[torch.randperm(fin.numel(), generator=generator)[:n_done]]
        pick = torch.cat([pick, fin])
    return torch.unique(pick).to(done.device)


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def judge_policy(rec: StepRecord, ref_net) -> Dict[str, float]:
    with torch.no_grad():
        lp = ref_net.log_prob(rec.obs, rec.action)
        v = ref_net.value(rec.obs)
    return {"logp_gap": _gap(rec.log_prob, lp), "value_gap": _gap(rec.value, v)}


def judge_env(rec: StepRecord, ref_env) -> Dict[str, float]:
    """The physics share out of bounds, the observation, reward and reset
    gaps, and the count of exact mismatches."""
    with torch.no_grad():
        want = ref_env.step(ref_state(rec.pre), rec.clipped)
        post = flat_state(want.state)
        out = want.terminated != rec.terminated
        for k, tol in STEP_BOUNDS.items():
            err = (rec.post[k] - post[k]).abs().reshape(len(out), -1).amax(1)
            out |= ~(err <= tol)
        got_state = ref_state(rec.post)
        obs = ref_env.observe(got_state)
        reward = ref_env.reward(got_state, rec.terminated)

        dur = float(ref_env.motion.duration)
        trunc = ~rec.terminated & (rec.post["elapsed_time"]
                                   >= ref_env.overtime + rec.post["init_time"])
        bad = int((rec.post["elapsed_time"] != post["elapsed_time"]).sum())
        bad += int((rec.post["init_time"] != rec.pre["init_time"]).sum())
        bad += int((rec.truncated != trunc).sum())
        bad += int((rec.done != (rec.terminated | trunc)).sum())
        keep = ~rec.done
        for k, v in rec.new_state.items():
            bad += int((v[keep] != rec.post[k][keep]).reshape(int(keep.sum()), -1)
                       .any(1).sum()) if keep.any() else 0
        bad += int((rec.new_obs[keep] != rec.res_obs[keep]).any(1).sum()) if keep.any() else 0

        reset_gap = 0.0
        fin = rec.done
        if fin.any():
            t0 = rec.new_state["init_time"][fin]
            bad += int(((t0 < 0) | (t0 >= dur)).sum())
            bad += int((rec.new_state["elapsed_time"][fin] != t0).sum())
            st, o = ref_env.reset_at(t0)
            want_reset = flat_state(st)
            reset_gap = max([_gap(rec.new_state[k][fin], want_reset[k])
                             for k in want_reset] + [_gap(rec.new_obs[fin], o)])
    return {"physics_out_share": float(out.float().mean()),
            "obs_gap": _gap(rec.res_obs, obs), "reward_gap": _gap(rec.reward, reward),
            "reset_gap": reset_gap, "mismatches": float(bad)}


def combine(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of each number over several checks."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


# -- training ----------------------------------------------------------------

def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the norms of ``got`` and ``want``,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = keep if keep is not None else list(want)
    norms = {k: float(want[k].double().norm()) for k in names}
    med = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in names:
        gap = abs(float(got[k].double().norm()) - norms[k])
        worst = max(worst, gap / max(norms[k], med, 1e-30))
    return worst


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(g.double().norm()) for k, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def judge_updates(losses_got: List[float], losses_want: List[float],
                  grad_got: Dict[str, torch.Tensor], grad_want: Dict[str, torch.Tensor],
                  change_got: Dict[str, torch.Tensor],
                  change_want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    loss_gap = max(abs(g - w) / max(abs(w), 1e-6) for g, w in zip(losses_got, losses_want))
    keep = moving_leaves(grad_want)
    return {"loss_gap": loss_gap, "grad_gap": leaf_gaps(grad_got, grad_want),
            "change_gap": leaf_gaps(change_got, change_want, keep)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a reading or without a limit, or not finite,
    fails."""
    checks, ok = {}, True
    for name in list(limits) + [k for k in numbers if k not in limits]:
        v, limit = numbers.get(name), limits.get(name)
        good = v is not None and limit is not None and v == v and v <= limit
        ok &= good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
