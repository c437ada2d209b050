"""The benchmark's frozen reference against the port's plain paths, on the CPU.

The reference (``portbench/reference``) is a frozen copy of the port's plain
code; these tests hold the two together at B <= 8 (the port's megastep runs
its plain version on the CPU), and the frozen operation counts against the
port's own. This file may import both; the reference imports nothing of
the port (``test_portbench_harness.py`` checks that).
"""

import os

import numpy as np
import pytest
import torch

from portbench import judge
from portbench.counts import physics, policy
from portbench.reference import env as ref_env_mod
from portbench.reference.a2c import A2CReference, A2CSettings
from portbench.reference.ppo import PPOReference, PPOSettings
from portbench.reference.policy import ActorCritic as RefAC, state_dict_from_npz

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NPZ = ROOT + "/results/policies/DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz"


@pytest.fixture(scope="module")
def envs():
    from pfpn_torch.envs.deepmimic import make

    return make("DeepMimicWalk-v0", device="cpu"), ref_env_mod.make("DeepMimicWalk-v0")


@pytest.mark.parametrize("links", [False, True])
def test_env_step_reset_observe_reward_match_port(envs, links):
    port, ref = envs
    port.engine.megastep_links = links
    g = torch.Generator().manual_seed(3)
    st, obs = port.reset_batch(4, g)
    rst, robs = ref.reset_at(st.init_time)
    assert torch.equal(obs, robs)
    a = torch.clamp(0.3 * torch.randn(4, port.action_size, generator=g),
                    torch.as_tensor(port.action_low), torch.as_tensor(port.action_high))
    got, want = port.step(st, a), ref.step(judge.ref_state(judge.flat_state(st)), a)
    for k, v in judge.flat_state(want.state).items():
        assert torch.allclose(judge.flat_state(got.state)[k], v, atol=1e-6), k
    for k in ("obs", "reward", "done", "terminated", "truncated"):
        assert torch.allclose(getattr(got, k).float(), getattr(want, k).float(), atol=1e-6), k
    port.engine.megastep_links = False


def test_policy_matches_port():
    from pfpn_torch.harness import build, settings
    from pfpn_torch.networks.actor_critic import load_jax_params

    class _Env:
        observation_size, action_size = 197, 36

    rc = settings.build("deepmimic_dppo_pfpn", particles=35)
    port = build.build_net(rc, _Env())
    with np.load(NPZ) as z:
        flat = {k: z[k] for k in z.files}
    port.load_state_dict(load_jax_params(flat))
    ref = RefAC(197, 36, 35, (1024, 512), (1024, 512), 5.0)
    ref.load_state_dict(state_dict_from_npz(flat))
    g = torch.Generator().manual_seed(5)
    obs = torch.randn(8, 197, generator=g)
    with torch.no_grad():
        a, lp, v, _ = port.act(obs, g)
        assert torch.allclose(ref.log_prob(obs, a), lp, atol=1e-5)
        assert torch.allclose(ref.value(obs), v, atol=1e-6)
        assert torch.allclose(ref.entropy(obs), port.entropy(obs), atol=1e-6)
    # a fresh run's initialization: the same draws from the same generator
    port.init_parameters(torch.Generator().manual_seed(9))
    ref.init_parameters(torch.Generator().manual_seed(9))
    for (n, p), (m, q) in zip(port.named_parameters(), ref.named_parameters()):
        assert n == m and torch.equal(p, q), n


def test_a2c_update_matches_port():
    from pfpn_torch.algos.a2c import A2C
    from pfpn_torch.algos.ppo import PPOConfig, PPOState
    from pfpn_torch.networks.actor_critic import ACConfig, ActorCritic
    from pfpn_torch.networks.heads import ParticleHead

    net = ActorCritic(ACConfig(obs_dim=197, head=ParticleHead(36, 35), entropy_beta=2.5e-4))
    g = torch.Generator().manual_seed(11)
    net.init_parameters(g)
    w0 = {k: v.clone() for k, v in net.state_dict().items()}
    T, B = 6, 4
    algo = A2C(None, net, PPOConfig(num_envs=B, unroll_length=T, minibatch_size=T * B,
                                    lr_actor=1e-4, lr_critic=1e-4, norm_clip=0.5))
    obs, nxt = 2 * torch.randn(T, B, 197, generator=g), 2 * torch.randn(T, B, 197, generator=g)
    with torch.no_grad():
        act, lp, v, _ = net.act(obs.reshape(T * B, 197), g)
        v_next = net.value(nxt.reshape(T * B, 197)).reshape(T, B)
    done = torch.rand(T, B, generator=g) < 0.2
    term = done & (torch.rand(T, B, generator=g) < 0.5)
    traj = {"obs": obs, "action": act.reshape(T, B, 36), "log_prob": lp.reshape(T, B),
            "value": v.reshape(T, B), "reward": torch.rand(T, B, generator=g),
            "next_value": v_next, "terminated": term, "done": done}
    state = PPOState(net=net, opt=algo.opt, head_stats=net.init_stats(), env_state=None,
                     obs=None, generator=g)
    _, metrics = algo.update(state, traj)

    ref = RefAC(197, 36, 35, (1024, 512), (1024, 512), 5.0)
    ref.load_state_dict(w0)
    loss, grads = A2CReference(ref, A2CSettings()).update(
        {"obs": obs, "action": traj["action"], "reward": traj["reward"],
         "terminated": term, "done": done, "next_obs": nxt})
    assert abs(loss - float(metrics["loss"])) <= 1e-5 * abs(loss)
    for k, p in ref.state_dict().items():
        assert torch.allclose(net.state_dict()[k], p, atol=1e-7, rtol=1e-5), k


def test_ppo_update_matches_port():
    """One DPPO round of four minibatches on seeded random weights: every
    minibatch's loss, the first clipped gradient (as the harness reads it
    from Adam's state) and the parameters after the round, with the port's
    permutation replayed by the harness's watch."""
    from pfpn_torch.algos.ppo import PPO, PPOConfig, PPOState
    from pfpn_torch.networks.actor_critic import ACConfig, ActorCritic
    from pfpn_torch.networks.heads import ParticleHead

    from portbench.algos import ppo as ppo_mod

    net = ActorCritic(ACConfig(obs_dim=197, head=ParticleHead(36, 35),
                               normalize_advantage=True))
    g = torch.Generator().manual_seed(13)
    net.init_parameters(g)
    with torch.no_grad():       # a normalizer away from the identity
        net.norm.mean.copy_(0.1 * torch.randn(197, generator=g))
        net.norm.std.copy_(1.0 + torch.rand(197, generator=g))
    w0 = {k: v.clone() for k, v in net.state_dict().items()}
    T, B, mb = 6, 4, 6
    algo = PPO(None, net, PPOConfig(num_envs=B, unroll_length=T, minibatch_size=mb))
    obs, nxt = 2 * torch.randn(T, B, 197, generator=g), 2 * torch.randn(T, B, 197, generator=g)
    with torch.no_grad():
        act, lp, v, _ = net.act(obs.reshape(T * B, 197), g)
        v_next = net.value(nxt.reshape(T * B, 197)).reshape(T, B)
    done = torch.rand(T, B, generator=g) < 0.2
    term = done & (torch.rand(T, B, generator=g) < 0.5)
    traj = {"obs": obs, "action": act.reshape(T, B, 36), "log_prob": lp.reshape(T, B),
            "value": v.reshape(T, B), "reward": torch.rand(T, B, generator=g),
            "next_value": v_next, "terminated": term, "done": done}
    state = PPOState(net=net, opt=algo.opt, head_stats=net.init_stats(), env_state=None,
                     obs=None, generator=g)
    rec = ppo_mod.watch(algo, lambda: True)
    algo.update(state, traj)
    assert len(rec["losses"]) == T * B // mb and len(rec["before"]) == 1

    ref = RefAC(197, 36, 35, (1024, 512), (1024, 512), 5.0)
    ref.load_state_dict(w0)
    losses, grads = PPOReference(ref, PPOSettings(minibatch_size=mb)).update(
        {"obs": obs, "action": traj["action"], "reward": traj["reward"],
         "terminated": term, "done": done, "next_obs": nxt}, rec["before"][0]["perms"])
    for got, want in zip(rec["losses"], losses):
        assert abs(float(got) - want) <= 1e-5 * max(abs(want), 1.0), (float(got), want)
    assert judge.leaf_gaps(rec["grad1"], grads) <= 1e-5
    for k, p in ref.state_dict().items():
        assert torch.allclose(net.state_dict()[k], p, atol=1e-7, rtol=1e-5), k


def test_ppo_step_from_a_snapshot_repeats_the_step():
    """From its own trail's snapshot ahead of each step (parameters,
    normalizer, Adam's moments), the reference makes that step again with
    the same loss and clipped gradient, and reaches the next snapshot,
    bit for bit: the footing on which the harness judges each of the
    port's steps from the port's own state."""
    g = torch.Generator().manual_seed(17)
    net = RefAC(197, 36, 35, (1024, 512), (1024, 512), 5.0)
    net.init_parameters(g)
    T, B, mb = 4, 6, 6
    traj = {"obs": 2 * torch.randn(T, B, 197, generator=g),
            "action": torch.randn(T, B, 36, generator=g),
            "reward": torch.rand(T, B, generator=g),
            "next_obs": 2 * torch.randn(T, B, 197, generator=g),
            "terminated": torch.zeros(T, B, dtype=torch.bool),
            "done": torch.rand(T, B, generator=g) < 0.2}
    perms = [torch.randperm(T * B, generator=g)]
    ref = PPOReference(net, PPOSettings(minibatch_size=mb))
    ref.update(traj, perms)
    trail = ref.trail[0]
    snaps = trail["steps"] + [trail["end"]]
    assert len(trail["steps"]) == T * B // mb

    again = PPOReference(RefAC(197, 36, 35, (1024, 512), (1024, 512), 5.0),
                         PPOSettings(minibatch_size=mb))
    again.load(snaps[0], 0)
    data = again.prepare(traj)
    for j, s in enumerate(trail["steps"]):
        again.load(s, j)
        loss, grads = again.step(data, perms[0][j * mb:(j + 1) * mb], True)
        assert loss == s["loss"]
        for n, grad in grads.items():
            assert torch.equal(grad, s["grad"][n]), n
        for k, v in again.net.state_dict().items():
            assert torch.equal(v, snaps[j + 1]["state"][k]), (j, k)


def test_frozen_counts_match_port(envs):
    from pfpn_torch.ops import megastep as ms

    port, ref = envs
    meta, pm = physics.meta_of(ref), port.engine.meta
    for links in (False, True):
        assert physics.flops_per_env(meta, links) == ms.megastep_flops(pm, emit_links=links)
        assert (physics.bytes_per_launch(meta, 8192, links)
                == ms.megastep_bytes(pm, 8192, emit_links=links))
    assert round(physics.flops_per_env(meta) * 8192 / 1e9, 1) == 63.5
    assert round(physics.bytes_per_launch(meta, 8192) / 1e6, 2) == 9.41
    cfg = {"obs_dim": 197, "action_dim": 36, "particles": 35,
           "actor_shape": [1024, 512], "critic_shape": [1024, 512]}
    actor, critic = policy.shapes(cfg)
    weights = sum(i * o for i, o in actor + critic)
    assert policy.act_flops(cfg) == 2 * weights
    ac = RefAC(197, 36, 35, (1024, 512), (1024, 512), 5.0)
    assert sum(p.numel() for p in ac.parameters()) == 2104517
