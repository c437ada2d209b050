"""PyTorch port: DPPO training against the JAX package, and the trainer.

* one ``PPO.update`` at full width (the shipped Walk DPPO + PFPN-35 policy,
  trunks 197 -> 1024 -> 512, head 512 -> 36 x 35) from identical parameters
  and a fixed trajectory made with numpy from a seed. The trajectory is one
  minibatch of 256 (32 steps x 8 envs, one epoch), so the shuffle cannot
  matter. Held: the losses and metrics (rtol 1e-5, atol 1e-6), the
  gradient of every parameter before the optimizer step (5e-5 of each
  tensor's largest entry), and the parameters, normalizer (1e-6) and head
  statistics (exact) after the update; the parameters also against JAX's
  clip + Adam applied to the port's own gradients (1e-6); each bound states
  its reading below;
* rollout semantics on a recording toy env (the port's counterpart of
  ``tests/test_algos.py:108-136``): the unclipped action is stored, the env
  receives the clipped one, ``next_value`` is the value of the pre-reset
  observation, episode returns and ``total_samples`` are counted;
* the port's PPO learns the toy MDP of ``tests/test_algos.py:139-163``;
* ``python -m pfpn_torch ... --train --device cpu`` at a tiny size (two
  envs, a 4-step unroll, one round) into ``tmp_path``, with
  ``PFPN_MEGASTEP_LINKS=1`` as on the card: a checkpoint is written,
  restores the same parameters, Adam state and generator, and a second run
  resumes from it.

Four tests: pytest-xdist's loadfile schedule hands out files with more
tests first, and this file must not start before ``tests/test_megastep.py``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos.ppo import PPO as TPPO, PPOConfig as TPPOConfig, PPOState  # noqa: E402
from pfpn_torch.envs.deepmimic import StepResult as TStepResult  # noqa: E402
from pfpn_torch.harness import cli, settings  # noqa: E402
from pfpn_torch.harness.build import build_algo  # noqa: E402
from pfpn_torch.harness.checkpoint import CheckpointManager  # noqa: E402
from pfpn_torch.networks.actor_critic import (  # noqa: E402
    ACConfig as TACConfig, ActorCritic as TActorCritic, load_jax_params,
)
from pfpn_torch.networks.heads import ParticleHead as TParticleHead, init_activation_stats  # noqa: E402
from pfpn_tpu.algos.gae import gae as j_gae  # noqa: E402
from pfpn_tpu.algos.ppo import PPO, PPOConfig, PPOState as JPPOState  # noqa: E402
from pfpn_tpu.networks import ACConfig, ActorCritic, ParticleHead  # noqa: E402
from pfpn_tpu.networks import value_norm as vnorm_mod  # noqa: E402
from pfpn_tpu.networks.heads import init_activation_stats as j_init_stats  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results", "policies",
                   "DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz")
LOSS_RTOL = 1e-5
# the policy loss is a mean of 256 terms ratio * advantage of size ~1 that
# cancels to ~0.02: its rounding is absolute (reading 2.0e-7)
LOSS_ATOL = 1e-6
# of each tensor's largest |gradient|: the log-probs reach ~60, where an
# fp32 ulp is 3.8e-6, so the ratio exp(lp - lp_old) and the policy gradient
# carry ~1e-5 of rounding in either package (readings: actor side up to
# 1.7e-5, head bias; critic side 7e-7)
GRAD_TOL = 5e-5
NORM_TOL = 1e-6
OPT_TOL = 1e-6    # as tests/test_torch_algos.py's clip + Adam against optax


def _unflatten(flat):
    """tools/export_policy.py:38-54 (params arrays -> nested pytree)."""
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def _flatten(tree, prefix="params"):
    out = {}
    items = tree.items() if isinstance(tree, dict) else ((f"#{i}", v) for i, v in enumerate(tree))
    for k, v in items:
        key = f"{prefix}/{k}"
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# one update at full width
# ---------------------------------------------------------------------------

def test_update_matches_jax_full_width():
    T, B = 32, 8
    with np.load(NPZ) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    head_j = ParticleHead(action_dim=36, particles=35, resample=-1, resample_interval=368)
    net_j = ActorCritic(ACConfig(obs_dim=197, head=head_j, normalize_advantage=True))
    ppo_j = PPO(None, net_j, PPOConfig(num_envs=B, unroll_length=T, minibatch_size=T * B))
    params = _unflatten({k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()
                         if k.startswith("params/")})
    norm = net_j.init_norm()._replace(mean=jnp.asarray(flat["norm/mean"]),
                                      std=jnp.asarray(flat["norm/std"]))

    # a fixed trajectory: observations around the normalizer's statistics,
    # actions near the policy's mode, behaviour log-probs off the current
    # ones (so the ratio clip engages), terminals and truncations
    rng = np.random.default_rng(31)
    obs = (flat["norm/mean"] + flat["norm/std"] * rng.standard_normal((T, B, 197))
           ).astype(np.float32)
    mode = np.asarray(jax.jit(net_j.act_deterministic)(params, norm, jnp.asarray(obs)))
    action = (mode + 0.05 * rng.standard_normal(mode.shape)).astype(np.float32)
    lp = np.asarray(jax.jit(net_j.log_prob)(params, norm, jnp.asarray(obs),
                                            jnp.asarray(action)))
    value = np.asarray(jax.jit(net_j.value)(params, norm, jnp.asarray(obs)))
    term = rng.random((T, B)) < 0.03
    traj = {
        "obs": obs, "action": action,
        "log_prob": (lp + 0.3 * rng.standard_normal(lp.shape)).astype(np.float32),
        "value": (value + 0.1 * rng.standard_normal(value.shape)).astype(np.float32),
        "reward": rng.random((T, B)).astype(np.float32),
        "next_value": (value + 0.1 * rng.standard_normal(value.shape)).astype(np.float32),
        "terminated": term, "done": term | (rng.random((T, B)) < 0.03),
    }

    # JAX: the gradient of the loss, then the update
    stats_j = j_init_stats(head_j)
    adv = j_gae(*(jnp.asarray(traj[k]) for k in ("reward", "value", "next_value",
                                                  "terminated", "done")), 0.95, 0.95)
    batch_j = {k: jnp.asarray(traj[k]).reshape((T * B,) + traj[k].shape[2:])
               for k in ("obs", "action", "log_prob", "value")}
    batch_j["advantage"] = adv.reshape(-1)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(ppo_j._loss, has_aux=True))(
        params, norm, batch_j)
    state_j = JPPOState(
        params=params, opt_state=ppo_j.tx.init(params), norm=norm, head_stats=stats_j,
        env_state=None, obs=None, key=jax.random.PRNGKey(0),
        global_step=jnp.zeros((), jnp.int32), total_samples=jnp.zeros((), jnp.int32),
        ep_return=jnp.zeros(B), last_ep_return=jnp.zeros(B), vnorm=vnorm_mod.init())
    state_j, metrics_j = jax.jit(ppo_j.update)(
        state_j, {k: jnp.asarray(v) for k, v in traj.items()})

    # the port, from the same parameters
    head_t = TParticleHead(action_dim=36, particles=35, resample=-1, resample_interval=368)
    net_t = TActorCritic(TACConfig(obs_dim=197, head=head_t, normalize_advantage=True))
    net_t.load_state_dict(load_jax_params(flat), strict=True)
    ppo_t = TPPO(None, net_t, TPPOConfig(num_envs=B, unroll_length=T, minibatch_size=T * B))
    traj_t = {k: torch.tensor(v) for k, v in traj.items()}
    state_t = PPOState(net=net_t, opt=ppo_t.opt, head_stats=init_activation_stats(head_t),
                       env_state=None, obs=None, generator=torch.Generator().manual_seed(0))
    batch_t = {k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()}
    loss_t, _ = ppo_t._loss(batch_t)
    loss_t.backward()
    print(f"\nmax |log_prob| {float(np.abs(lp).max()):.4g}")
    print(f"loss: port {float(loss_t.detach()):.7g}, JAX {float(loss_j):.7g}")
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=LOSS_RTOL)
    named = dict(net_t.named_parameters())
    grads_want = load_jax_params(_flatten(grads_j))
    assert set(grads_want) == set(named)
    rel = {}
    for name, g in grads_want.items():
        rel[name] = _max_err(named[name].grad.numpy(), g.numpy()) / float(g.abs().max())
        print(f"gradient {name}: max abs err / max |grad| {rel[name]:.2e}")
    for name, r in rel.items():
        assert r <= GRAD_TOL, name

    # the gradients the port's optimizer step is given, as it is given them
    step_grads = {}
    opt_step = ppo_t.opt.step

    def capturing_step():
        step_grads.update({k: p.grad.detach().clone() for k, p in named.items()})
        opt_step()

    ppo_t.opt.step = capturing_step
    state_t, metrics_t = ppo_t.update(state_t, traj_t)
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        got, want = float(metrics_t[k]), float(np.asarray(metrics_j[k]))
        print(f"metric {k}: port {got:.7g}, JAX {want:.7g}")
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    # Adam's first step moves a parameter by lr g / (|g| + 1e-8), g clipped
    # by the global norm: by lr wherever |g| >> 1e-8, but not where g is
    # small and its rounding (up to GRAD_TOL of the tensor's largest entry)
    # is large against it. Each parameter is held to the change that this
    # gradient bound allows, plus 1e-5 of the step (optax forms the bias
    # correction 1 - 0.999^t in fp32, 1.3e-5 off at t = 1, which moves its
    # first step by 6.4e-6 of itself) and two fp32 ulps of |p| + lr.
    params_want = load_jax_params(_flatten(state_j.params))
    g_norm = np.sqrt(sum(float(np.sum(g.numpy().astype(np.float64) ** 2))
                         for g in grads_want.values()))
    clip = min(1.0, 1.0 / g_norm)

    def adam1(g):
        return 1e-4 * clip * g / (np.abs(clip * g) + 1e-8)

    worst, n_loose, n_all = 0.0, 0, 0
    for k, v in params_want.items():
        g = grads_want[k].numpy().astype(np.float64)
        delta = GRAD_TOL * np.abs(g).max()
        allowed = (np.maximum(np.abs(adam1(g + delta) - adam1(g)),
                              np.abs(adam1(g - delta) - adam1(g)))
                   + 1e-5 * np.abs(adam1(g))
                   + 2 * np.spacing(np.abs(v.numpy()) + np.float32(1e-4)))
        err = np.abs(named[k].detach().numpy().astype(np.float64) - v.numpy())
        worst = max(worst, float(err.max()))
        n_loose += int((allowed > 0.1 * 1e-4).sum())
        n_all += allowed.size
        assert (err <= allowed).all(), (k, float((err - allowed).max()))
    print(f"post-update parameters: max abs err {worst:.2e} (clip scale {clip:.3g}); "
          f"{n_loose} of {n_all} entries allowed more than 0.1 lr")
    # where that bound is loose (small gradients), JAX's own clip + Adam
    # applied to the port's step gradients holds every entry at OPT_TOL
    own_flat = {}
    for key, v in _flatten(params).items():
        (name, _), = load_jax_params({key: v}).items()
        g = step_grads[name].numpy()
        own_flat[key[len("params/"):]] = jnp.asarray(g.T if key.endswith("/w") else g)
    updates, _ = jax.jit(ppo_j.tx.update)(_unflatten(own_flat), ppo_j.tx.init(params), params)
    want_own = load_jax_params(_flatten(jax.tree.map(lambda p, u: p + u, params, updates)))
    err_own = max(_max_err(named[k].detach().numpy(), v.numpy()) for k, v in want_own.items())
    print(f"post-update parameters vs JAX's clip + Adam of the port's gradients: {err_own:.2e}")
    assert err_own <= OPT_TOL
    for k in ("mean", "std"):
        err = _max_err(getattr(net_t.norm, k).numpy(), getattr(state_j.norm, k))
        print(f"post-update normalizer {k}: {err:.2e}")
        assert err <= NORM_TOL * max(1.0, float(np.abs(getattr(state_j.norm, k)).max()))
    assert state_t.global_step == int(state_j.global_step) == 1
    assert state_t.head_stats["train_flag"] == float(state_j.head_stats["train_flag"]) == 1
    for k in ("max_active", "sum_active"):
        np.testing.assert_array_equal(state_t.head_stats[k].numpy(),
                                      np.asarray(state_j.head_stats[k]))


# ---------------------------------------------------------------------------
# rollout semantics and the toy MDP
# ---------------------------------------------------------------------------

class RecordingEnv:
    """Episodes of three steps; env b earns 1 + b per step; even envs end
    in a terminal, odd ones in a truncation. Records the actions it gets."""

    observation_size = 3
    action_size = 2
    action_low = np.full(2, -1.0, np.float32)
    action_high = np.full(2, 1.0, np.float32)

    def __init__(self):
        self.received = []

    @staticmethod
    def _obs(t):
        return torch.stack([t, 0.5 * t, torch.ones_like(t)], -1)

    def reset_batch(self, n, generator=None):
        t = torch.zeros(n)
        return t, self._obs(t)

    def step_autoreset(self, t, actions, generator=None):
        self.received.append(actions.clone())
        t = t + 1.0
        done = t % 3 == 0
        even = torch.arange(t.shape[0]) % 2 == 0
        reward = 1.0 + torch.arange(t.shape[0], dtype=torch.float32)
        res = TStepResult(t, self._obs(t), reward, done, done & even, done & ~even)
        new_t = torch.where(done, torch.zeros_like(t), t)
        return new_t, self._obs(new_t), res


def _toy_net(action_dim, particles, obs_dim, **kw):
    return TActorCritic(TACConfig(
        obs_dim=obs_dim, head=TParticleHead(action_dim=action_dim, particles=particles, **kw),
        actor_shape=(32,), critic_shape=(32,), normalize_state=False,
        normalize_advantage=True, gamma=0.0, lambd=0.0))


def test_rollout_semantics():
    env = RecordingEnv()
    net = _toy_net(2, 5, 3, resample=0)
    ppo = TPPO(env, net, TPPOConfig(num_envs=4, unroll_length=7, minibatch_size=28))
    state = ppo.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.head.particles.fill_(3.0)          # every draw lies beyond the bound 1
    state, traj = ppo.rollout(state)
    got = torch.stack(env.received)
    assert bool((traj["action"] > 1.0).any())
    torch.testing.assert_close(got, torch.clamp(traj["action"], -1.0, 1.0), rtol=0, atol=0)
    with torch.no_grad():
        t = torch.arange(1, 8, dtype=torch.float32)[:, None].expand(7, 4)
        t_pre = torch.where(t > 3, t - 3, t)               # pre-reset step counters
        t_pre = torch.where(t_pre > 3, t_pre - 3, t_pre)
        want_next = net.value(RecordingEnv._obs(t_pre))
        torch.testing.assert_close(traj["next_value"], want_next, rtol=0, atol=0)
        torch.testing.assert_close(traj["log_prob"], net.log_prob(traj["obs"], traj["action"]),
                                   rtol=1e-6, atol=1e-5)
    per_env = 1.0 + torch.arange(4, dtype=torch.float32)
    torch.testing.assert_close(state.last_ep_return, 3.0 * per_env)   # done at t = 3, 6
    torch.testing.assert_close(state.ep_return, per_env)              # one step since
    assert state.total_samples == 28 and isinstance(state.total_samples, int)
    np.testing.assert_array_equal(traj["terminated"].numpy()[2], [True, False, True, False])
    np.testing.assert_array_equal(traj["done"].numpy()[2], True)
    # each step's particle weights were folded into the statistics
    np.testing.assert_allclose(state.head_stats["sum_active"].sum(-1).numpy(), 28.0, rtol=1e-5)


class ToyEnv:
    """One-step bandit: reward -(a - 0.4)^2 summed over two dims
    (tests/test_algos.py:109)."""

    observation_size = 4
    action_size = 2
    action_low = np.full(2, -1.0, np.float32)
    action_high = np.full(2, 1.0, np.float32)

    def reset_batch(self, n, generator=None):
        return torch.zeros(n), torch.zeros(n, 4)

    def step_autoreset(self, states, actions, generator=None):
        reward = -torch.sum((actions - 0.4) ** 2, -1)
        obs = torch.zeros(actions.shape[0], 4)
        done = torch.ones(actions.shape[0], dtype=torch.bool)
        return states, obs, TStepResult(states, obs, reward, done, torch.zeros_like(done), done)


def test_ppo_learns_on_toy_mdp():
    net = _toy_net(2, 9, 4, resample=0)
    ppo = TPPO(ToyEnv(), net, TPPOConfig(num_envs=32, unroll_length=8, minibatch_size=64,
                                         opt_epochs=2, lr_actor=3e-3, lr_critic=3e-3))
    state = ppo.init_state(torch.Generator().manual_seed(0))
    for _ in range(31):
        state, metrics = ppo.train_round(state)
    with torch.no_grad():
        a = net.act_deterministic(torch.zeros(1, 4))[0].numpy()
    print(f"\ntoy MDP: deterministic action {a}, last mean reward {metrics['episode_reward']:.4f}")
    np.testing.assert_allclose(a, [0.4, 0.4], atol=0.15)
    assert state.global_step == 31 * 2 * 4


# ---------------------------------------------------------------------------
# the CLI, on the CPU
# ---------------------------------------------------------------------------

def test_cli_trains_and_resumes_on_cpu(tmp_path, monkeypatch):
    # TensorBoard stays out: importing it pulls in TensorFlow (~14 s here)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    build = settings.build

    def tiny(*args, **kwargs):
        cfg = build(*args, **kwargs)
        return dataclasses.replace(
            cfg, workers=2,
            worker=dataclasses.replace(cfg.worker, unroll_length=4, batch_size=4),
            network=dataclasses.replace(cfg.network, actor_shape=(32,), critic_shape=(32,)))

    monkeypatch.setattr(settings, "build", tiny)
    # the JAX package's switch to the megastep's emit_links variant, which
    # the training path on the card takes (here: its plain version)
    monkeypatch.setenv("PFPN_MEGASTEP_LINKS", "1")
    argv = ["--env", "DeepMimicWalk-v0", "--setting", "deepmimic_dppo_pfpn",
            "--particles", "35", "--seed", "5", "--train", "--device", "cpu",
            "--max_rounds", "1", "--root", str(tmp_path)]
    algo, state = cli.main(argv)
    assert state.global_step == 1 and state.total_samples == 8
    assert algo.env.engine.megastep_links
    assert algo.env.engine.mega.launches_links == algo.env.engine.mega.launches == 0
    cfg = tiny("deepmimic_dppo_pfpn", particles=35, env="DeepMimicWalk-v0", seed=5)
    ckpt = CheckpointManager(cfg.checkpoint_dir(str(tmp_path)))
    assert ckpt.steps() == [1]
    assert os.path.exists(os.path.join(cfg.log_dir(str(tmp_path)), "metrics.jsonl"))

    # a fresh algorithm restores exactly what was saved
    fresh = build_algo(cfg, "cpu")
    st = fresh.init_state(torch.Generator().manual_seed(99))
    st = ckpt.restore_latest(st)
    for (k, v), (k2, v2) in zip(algo.net.state_dict().items(), fresh.net.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    sd, sd2 = algo.opt.state_dict()["state"], fresh.opt.state_dict()["state"]
    assert sd.keys() == sd2.keys() and all(
        torch.equal(sd[i]["exp_avg_sq"], sd2[i]["exp_avg_sq"]) for i in sd)
    assert torch.equal(st.generator.get_state(), state.generator.get_state())
    torch.testing.assert_close(st.obs, state.obs, rtol=0, atol=0)
    assert (st.global_step, st.total_samples) == (1, 8)

    # and a second run resumes from it
    algo2, state2 = cli.main(argv)
    assert state2.global_step == 2 and state2.total_samples == 16
    assert ckpt.steps() == [2]
