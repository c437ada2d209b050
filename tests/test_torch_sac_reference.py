"""PyTorch port: SAC-PFPN against the benchmark's plain reference.

``portbench/reference/sac.py`` is SAC's update in plain float32 PyTorch,
imported from nothing of the port. At small widths (obs 12, actions 5 on
random bounds, trunk and critics of 24, 6 particles, batch 32), from the
same seeded random weights, targets apart from the critics, normalizer and
batches and draws, the port's ``SAC._update_step`` and the reference's
``SACReference.step`` are held together over one and three steps: both
losses, each parameter's clipped gradient as Adam takes it, the
parameters, the targets, ``log_alpha`` and the normalizer.

A short ``train_round`` on the Walk env at 2 envs with a small network
then holds the ring's rows equal, exactly, to the transitions the env
produced, and the counters (``SAC.env_steps``, ``SAC.grad_steps``, the
ring's ``rows_inserted`` and ``rows_drawn``) to what ran; one profiled
round holds the number of ``sac.env_step`` and ``sac.update_step``
regions to the counters. About 15 s in one process on the CPU.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pfpn_torch.algos.sac import SAC, SACConfig, SACNet  # noqa: E402
from pfpn_torch.harness import settings  # noqa: E402
from pfpn_torch.harness.build import build_env, build_head  # noqa: E402
from pfpn_torch.networks import heads  # noqa: E402
from pfpn_torch.networks.actor_critic import ACConfig  # noqa: E402
from portbench.reference import sac as ref_sac  # noqa: E402

torch.set_num_threads(1)

OBS, ACT, PARTICLES, WIDTH, BATCH = 12, 5, 6, 24, 32
# Both sides run the same float32 operations in the same order on the CPU;
# they part only where a fused or differently blocked kernel rounds
# otherwise (the Q held fixed through ``functional_call`` against
# ``F.linear`` on detached weights, Polyak through ``_foreach`` against
# per-tensor ops). Losses: a few ulps of a float32 sum over the batch.
LOSS_RTOL = 1e-6
# Gradients: round-off of sums over the batch, relative to the tensor's
# largest entry.
GRAD_RTOL = 1e-5
# Parameters and targets after Adam and Polyak: Adam moves an entry by about
# lr = 1e-4 a step, so three ulps of that step over three steps.
PARAM_TOL = 1e-10 + 3e-8
# The normalizer's moving average: float32 round-off of the batch's mean and
# standard deviation, at the data's scale.
NORM_TOL = 1e-6


class Bounds:
    """An env as the clip sees it: its action bounds."""

    def __init__(self, low, high):
        self.action_low, self.action_high = low, high


def _pair(seed=3):
    rng = np.random.default_rng(seed)
    low = -rng.uniform(0.5, 2.0, ACT).astype(np.float32)
    high = (low + rng.uniform(1.0, 3.0, ACT)).astype(np.float32)
    head = heads.ParticleHead(action_dim=ACT, particles=PARTICLES, squash=True,
                              resample=-1, resample_interval=12000,
                              action_low=low, action_high=high)
    net = SACNet(ACConfig(obs_dim=OBS, head=head, actor_shape=(WIDTH,),
                          critic_shape=(WIDTH, WIDTH)), "sac")
    gen = torch.Generator().manual_seed(seed)
    net.init_parameters(gen)
    with torch.no_grad():       # off their init, so that every path carries weight
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
        net.log_alpha.fill_(-0.7)
        net.norm.mean.copy_(torch.randn(OBS, generator=gen))
        net.norm.std.copy_(0.5 + torch.rand(OBS, generator=gen))
    algo = SAC(Bounds(low, high), net, SACConfig(num_envs=1, batch_size=BATCH))
    with torch.no_grad():
        for p in algo.target.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    ref_net = ref_sac.SACNet(OBS, ACT, PARTICLES, (WIDTH,), (WIDTH, WIDTH), low, high)
    ref_net.load_state_dict(net.state_dict())
    ref = ref_sac.SACReference(ref_net)
    ref.target.load_state_dict(algo.target.state_dict())
    return algo, ref, rng


def _inputs(algo, rng):
    low, high = algo.env.action_low, algo.env.action_high
    mean = algo.net.norm.mean.numpy()
    obs = (mean + 2 * rng.standard_normal((BATCH, OBS))).astype(np.float32)
    batch = {"obs": obs,
             "action": (low + (high - low) * rng.random((BATCH, ACT))).astype(np.float32),
             "reward": rng.random(BATCH).astype(np.float32),
             "not_terminal": (rng.random(BATCH) > 0.1).astype(np.float32),
             "next_obs": (obs + 0.3 * rng.standard_normal((BATCH, OBS))).astype(np.float32)}
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    return {k: torch.tensor(v) for k, v in batch.items()}, algo.update_draws(BATCH, gen)


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("steps", [1, 3])
def test_update_steps_match_reference(steps):
    algo, ref, rng = _pair()
    named = dict(algo.net.named_parameters())
    grads = {}
    adam_step = algo.opt.adam.step

    def capturing(*args, **kw):
        grads.update({k: p.grad.detach().clone() for k, p in named.items()})
        return adam_step(*args, **kw)

    algo.opt.adam.step = capturing
    stats = algo.net.init_stats()
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0, "target": 0.0, "norm": 0.0}
    for g in range(steps):
        batch, draws = _inputs(algo, rng)
        gstep, stats, m = algo._update_step(batch, draws, g, stats, None)
        want = ref.step(batch, draws)
        assert gstep == ref.global_step == g + 1
        for k in ("critic_loss", "actor_loss", "loss"):
            e = abs(float(m[k]) - want[k]) / max(abs(want[k]), 1e-6)
            worst["loss"] = max(worst["loss"], e)
            assert e <= LOSS_RTOL, (g, k, float(m[k]), want[k])
        assert float(m["alpha"]) == pytest.approx(float(torch.exp(ref.net.log_alpha.detach())),
                                                  rel=1e-7)
        assert set(grads) == set(want["grad"])
        for k, v in want["grad"].items():
            scale = max(float(v.abs().max()), 1e-30)
            worst["grad"] = max(worst["grad"], _err(grads[k], v) / scale)
            assert _err(grads[k], v) <= GRAD_RTOL * scale, (g, k)
        ref_state = ref.net.state_dict()
        for k, p in named.items():
            worst["param"] = max(worst["param"], _err(p.detach(), ref_state[k]))
            assert _err(p.detach(), ref_state[k]) <= PARAM_TOL, (g, k)
        for k, v in algo.target.state_dict().items():
            worst["target"] = max(worst["target"], _err(v, ref.target.state_dict()[k]))
            assert _err(v, ref.target.state_dict()[k]) <= PARAM_TOL, (g, k)
        for k in ("mean", "std"):
            e = _err(getattr(algo.net.norm, k), getattr(ref.net.norm, k))
            worst["norm"] = max(worst["norm"], e)
            assert e <= NORM_TOL, (g, k)
    print(f"\n{steps} step(s), worst gaps: {worst}")
    # the targets moved off their start and log_alpha took its steps
    assert not torch.equal(algo.target.state_dict()["q1.layers.0.weight"],
                           _pair()[0].target.state_dict()["q1.layers.0.weight"])
    assert float(algo.net.log_alpha) != -0.7


@pytest.fixture(scope="module")
def walk_sac():
    """SAC on the Walk env at 2 envs, 2 gradient steps of batch 4 after
    each env step, with a small squashed PFPN network."""
    rc = settings.build("deepmimic_sac_pfpn", particles=4, env_multiplier=2)
    env = build_env(rc, "cpu")
    net = SACNet(ACConfig(obs_dim=env.observation_size, head=build_head(rc, env),
                          actor_shape=(16,), critic_shape=(16,)), "sac")
    algo = SAC(env, net, SACConfig(num_envs=2, batch_size=4, steps_per_round=3,
                                   updates_per_step=2, buffer_capacity=32))
    state = algo.init_state(torch.Generator().manual_seed(5))
    return algo, state


def test_train_round_ring_holds_the_env_transitions(walk_sac):
    algo, state = walk_sac
    env, seen = algo.env, []
    step = env.step_autoreset
    obs = {"now": state.obs}

    def recording(states, actions, generator=None):
        out = step(states, actions, generator)
        res = out[2]
        seen.append({"obs": obs["now"].clone(), "action": actions.clone(),
                     "reward": res.reward.clone(),
                     "not_terminal": 1.0 - res.terminated.float(),
                     "next_obs": res.obs.clone()})
        obs["now"] = out[1]
        return out

    env.step_autoreset = recording
    try:
        state, out = algo.train_round(state)
    finally:
        del env.step_autoreset
    buf = state.buffer
    n = 3 * 2
    assert (buf.size, buf.pointer, buf.rows_inserted) == (n, n, n)
    want = torch.cat([torch.cat([s[k].reshape(2, -1) for k, _ in buf.spec], 1) for s in seen])
    assert torch.equal(buf.data[:n], want)
    assert not buf.data[n:].any()
    # the gate opens once the ring holds a batch: after the second env step
    assert (algo.env_steps, algo.grad_steps, out["global_step"]) == (3, 4, 4)
    assert buf.rows_drawn == 4 * 4


def test_profiled_round_regions_match_counters(walk_sac):
    """A round of 2 env steps at batch 2: the gate opens after the first,
    so 2 env-step regions and 4 gradient-step regions. The regions are
    counted from the profiler's raw events (``key_averages`` builds a tree
    of every event first, minutes for an env step's ops on the CPU)."""
    env, net = walk_sac[0].env, walk_sac[0].net
    algo = SAC(env, net, SACConfig(num_envs=2, batch_size=2, steps_per_round=2,
                                   updates_per_step=2, buffer_capacity=32))
    state = algo.init_state(torch.Generator().manual_seed(6))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        algo.train_round(state)
    counts = {}
    for e in prof.profiler.kineto_results.events():
        counts[e.name()] = counts.get(e.name(), 0) + 1
    assert (algo.env_steps, algo.grad_steps, state.buffer.rows_drawn) == (2, 4, 8)
    assert counts.get("sac.env_step") == algo.env_steps
    assert counts.get("sac.update_step") == algo.grad_steps
