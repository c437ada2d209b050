"""PyTorch port: the DPPO Gaussian and categorical heads against JAX.

* the distribution functions (``distributions/gaussian.py``,
  ``categorical.py``) on the same inputs, made with numpy from a seed, to
  1e-6 (fp32 of values up to ~50); the draws, which come from different
  generators, by their construction from the same noise and by the
  categorical's frequencies; and ``DiscreteActionWrapper``'s table and
  mapping exactly;
* one ``PPO.update`` at full width (trunks 197 -> 1024 -> 512, 36 action
  dims, 35 bins for the categorical head) for ``deepmimic_dppo_gauss`` and
  ``deepmimic_dppo_dis``, from identical parameters and a fixed trajectory
  of one minibatch of 256, as ``tests/test_torch_train.py``'s
  ``test_update_matches_jax_full_width`` holds the particle head: the loss
  and metrics (rtol 1e-5, atol 1e-6), every parameter's gradient (5e-5 of
  the tensor's largest entry; the Gaussian's state-dependent log-sigma
  layer, zero at init, is held by its gradient), and the parameters after
  the step against JAX's clip + Adam applied to the port's gradients
  (1e-6);
* ``load_jax_params`` for both heads (and the Gaussian's ``log_sigma`` row
  and ``max_sigma`` forms), and ``export_jax_params`` back, exactly.

Four tests, so that pytest-xdist's loadfile schedule does not start this
file before ``tests/test_megastep.py``.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos.ppo import PPO as TPPO, PPOConfig as TPPOConfig, PPOState  # noqa: E402
from pfpn_torch.distributions import categorical as t_cat  # noqa: E402
from pfpn_torch.distributions import gaussian as t_gauss  # noqa: E402
from pfpn_torch.envs.deepmimic import make as t_make  # noqa: E402
from pfpn_torch.envs.wrappers import DiscreteActionWrapper as TWrapper  # noqa: E402
from pfpn_torch.harness.build import build_algo, build_head  # noqa: E402
from pfpn_torch.harness.settings import build as t_build  # noqa: E402
from pfpn_torch.networks import heads as t_heads  # noqa: E402
from pfpn_torch.networks.actor_critic import (  # noqa: E402
    ACConfig as TACConfig, ActorCritic as TActorCritic, export_jax_params, load_jax_params,
)
from pfpn_tpu.algos.gae import gae as j_gae  # noqa: E402
from pfpn_tpu.algos.ppo import PPO, PPOConfig, PPOState as JPPOState  # noqa: E402
from pfpn_tpu.distributions import categorical as j_cat  # noqa: E402
from pfpn_tpu.distributions import gaussian as j_gauss  # noqa: E402
from pfpn_tpu.envs.wrappers import DiscreteActionWrapper  # noqa: E402
from pfpn_tpu.harness.settings import build as j_build  # noqa: E402
from pfpn_tpu.networks import ACConfig, ActorCritic, CategoricalHead, GaussianHead  # noqa: E402
from pfpn_tpu.networks import value_norm as vnorm_mod  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results", "policies",
                   "DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz")
DIST_TOL = 1e-6
LOSS_RTOL = 1e-5      # tests/test_torch_train.py's bounds
LOSS_ATOL = 1e-6
GRAD_TOL = 5e-5
OPT_TOL = 1e-6


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


def test_distributions_and_wrapper_match_jax():
    rng = np.random.default_rng(0)
    mu = rng.standard_normal((64, 36)).astype(np.float32)
    sigma = np.exp(rng.uniform(-4, 0.5, (64, 36))).astype(np.float32)
    x = (mu + sigma * 3 * rng.standard_normal((64, 36))).astype(np.float32)
    u = rng.uniform(-1.2, 1.2, (64, 36)).astype(np.float32)
    T = torch.tensor
    for name, got, want in (
            ("gauss.log_prob", t_gauss.log_prob(T(mu), T(sigma), T(x)),
             j_gauss.log_prob(mu, sigma, x)),
            ("gauss.tanh_correction", t_gauss.tanh_correction(T(x)), j_gauss.tanh_correction(x)),
            ("gauss.log_prob_squashed", t_gauss.log_prob_squashed(T(mu), T(sigma), T(x)),
             j_gauss.log_prob_squashed(mu, sigma, x)),
            ("gauss.entropy", t_gauss.entropy(T(sigma)), j_gauss.entropy(sigma)),
            ("gauss.atanh_safe", t_gauss.atanh_safe(T(u)), j_gauss.atanh_safe(u))):
        want = np.asarray(want)
        err = _max_err(got.numpy(), want) / max(1.0, float(np.abs(want).max()))
        print(f"\n{name}: {err:.2e} of max(1, |value|)", end="")
        assert err <= DIST_TOL, name
    g = torch.Generator().manual_seed(1)
    draw = t_gauss.sample(T(mu), T(sigma), g)
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(draw, T(mu) + T(sigma) * eps, rtol=0, atol=0)

    logits = (3 * rng.standard_normal((64, 36, 35))).astype(np.float32)
    acts = rng.integers(0, 35, (64, 36))
    for name, got, want in (
            ("cat.log_prob", t_cat.log_prob(T(logits), T(acts)),
             j_cat.log_prob(logits, jnp.asarray(acts, jnp.int32))),
            ("cat.entropy", t_cat.entropy(T(logits)), j_cat.entropy(logits))):
        want = np.asarray(want)
        err = _max_err(got.numpy(), want) / max(1.0, float(np.abs(want).max()))
        print(f"\n{name}: {err:.2e} of max(1, |value|)", end="")
        assert err <= DIST_TOL, name
    np.testing.assert_array_equal(t_cat.mode(T(logits)).numpy(), np.asarray(j_cat.mode(logits)))
    # the draw's frequencies follow the softmax (20,000 draws of 4 x 5 bins)
    small = T(logits[:4, 0, :5]).expand(20000, 4, 5)
    draws = t_cat.sample(small, torch.Generator().manual_seed(2))
    assert draws.dtype == torch.int64
    freq = torch.nn.functional.one_hot(draws, 5).float().mean(0)
    err = float((freq - torch.softmax(small[0], -1)).abs().max())
    print(f"\ncategorical draw frequencies vs softmax: {err:.2e}")
    assert err <= 0.015

    # the discrete wrapper: bin i -> low + i (high - low) / (n - 1)
    env_t = TWrapper(t_make("DeepMimicWalk-v0", device="cpu"), 35)
    low = env_t.env.action_low
    high = env_t.env.action_high
    env_j = DiscreteActionWrapper(type("Bounds", (), {
        "action_low": low, "action_high": high, "action_size": 36,
        "observation_size": 197})(), 35)
    np.testing.assert_array_equal(env_t.table, env_j.table)
    got = env_t.continuous(T(acts[:4]))
    want = jax.vmap(env_j._continuous)(jnp.asarray(acts[:4]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert env_t.action_low is None and env_t.action_high is None
    assert env_t.engine is env_t.env.engine and env_t.device == env_t.env.device
    assert env_t.reset_at.__self__ is env_t.env


def _jax_net(kind):
    head = (GaussianHead(action_dim=36, init_sigma=0.05) if kind == "gauss"
            else CategoricalHead(action_dim=36, bins=35))
    return ActorCritic(ACConfig(obs_dim=197, head=head, normalize_advantage=True))


@pytest.mark.parametrize("kind", ["gauss", "dis"])
def test_update_matches_jax_full_width(kind):
    T, B = 32, 8
    setting = f"deepmimic_dppo_{kind}"
    worker = j_build(setting).worker
    assert dataclasses.asdict(t_build(setting).worker) == dataclasses.asdict(worker)
    net_j = _jax_net(kind)
    cfg = dict(num_envs=B, unroll_length=T, minibatch_size=T * B,
               lr_actor=worker.lr_actor, lr_critic=worker.lr_critic)
    ppo_j = PPO(None, net_j, PPOConfig(**cfg))
    params = net_j.init(jax.random.PRNGKey(7))
    with np.load(NPZ) as z:
        nmean, nstd = z["norm/mean"].astype(np.float32), z["norm/std"].astype(np.float32)
    norm = net_j.init_norm()._replace(mean=jnp.asarray(nmean), std=jnp.asarray(nstd))

    # a fixed trajectory: observations around the normalizer's statistics,
    # actions near the policy's mode, behaviour log-probs off the current
    # ones (so the ratio clip engages), terminals and truncations
    rng = np.random.default_rng(41)
    obs = (nmean + nstd * rng.standard_normal((T, B, 197))).astype(np.float32)
    mode = np.asarray(jax.jit(net_j.act_deterministic)(params, norm, jnp.asarray(obs)))
    if kind == "gauss":
        action = (mode + 0.05 * rng.standard_normal(mode.shape)).astype(np.float32)
    else:
        action = np.where(rng.random(mode.shape) < 0.3, rng.integers(0, 35, mode.shape),
                          mode).astype(np.int32)
    lp = np.asarray(jax.jit(net_j.log_prob)(params, norm, jnp.asarray(obs), jnp.asarray(action)))
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

    adv = j_gae(*(jnp.asarray(traj[k]) for k in ("reward", "value", "next_value",
                                                  "terminated", "done")), 0.95, 0.95)
    batch_j = {k: jnp.asarray(traj[k]).reshape((T * B,) + traj[k].shape[2:])
               for k in ("obs", "action", "log_prob", "value")}
    batch_j["advantage"] = adv.reshape(-1)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(ppo_j._loss, has_aux=True))(
        params, norm, batch_j)
    state_j = JPPOState(
        params=params, opt_state=ppo_j.tx.init(params), norm=norm,
        head_stats=net_j.init_stats(), env_state=None, obs=None, key=jax.random.PRNGKey(0),
        global_step=jnp.zeros((), jnp.int32), total_samples=jnp.zeros((), jnp.int32),
        ep_return=jnp.zeros(B), last_ep_return=jnp.zeros(B), vnorm=vnorm_mod.init())
    state_j, metrics_j = jax.jit(ppo_j.update)(
        state_j, {k: jnp.asarray(v) for k, v in traj.items()})

    # the port, from the same parameters, its head built as the preset builds it
    head_t = build_head(t_build(setting), type("E", (), {"action_size": 36})())
    net_t = TActorCritic(TACConfig(obs_dim=197, head=head_t, normalize_advantage=True))
    flat = _flatten(params)
    flat.update({f"norm/{k}": np.asarray(v) for k, v in norm._asdict().items()})
    net_t.load_state_dict(load_jax_params(flat), strict=True)
    ppo_t = TPPO(None, net_t, TPPOConfig(**cfg))
    traj_t = {k: torch.tensor(v) for k, v in traj.items()}
    assert traj_t["action"].dtype == (torch.float32 if kind == "gauss" else torch.int32)
    state_t = PPOState(net=net_t, opt=ppo_t.opt, head_stats=net_t.init_stats(),
                       env_state=None, obs=None, generator=torch.Generator().manual_seed(0))
    batch_t = {k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()}
    loss_t, _ = ppo_t._loss(batch_t)
    loss_t.backward()
    print(f"\n{kind}: loss port {float(loss_t.detach()):.7g}, JAX {float(loss_j):.7g}")
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=LOSS_RTOL)
    named = dict(net_t.named_parameters())
    grads_want = load_jax_params(_flatten(grads_j))
    assert set(grads_want) == set(named)
    for name, g in grads_want.items():
        rel = _max_err(named[name].grad.numpy(), g.numpy()) / float(g.abs().max())
        print(f"gradient {name}: max abs err / max |grad| {rel:.2e}")
        assert float(g.abs().max()) > 0 and rel <= GRAD_TOL, name

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
    # JAX's clip + Adam (two groups for gauss, whose learning rates differ)
    # applied to the gradients the port's optimizer step was given
    own_flat = {}
    for key, v in _flatten(params).items():
        (name, _), = load_jax_params({key: v}).items()
        g = step_grads[name].numpy()
        own_flat[key[len("params/"):]] = jnp.asarray(g.T if key.endswith("/w") else g)
    updates, _ = jax.jit(ppo_j.tx.update)(_unflatten(own_flat), ppo_j.tx.init(params), params)
    want_own = load_jax_params(_flatten(jax.tree.map(lambda p, u: p + u, params, updates)))
    err_own = max(_max_err(named[k].detach().numpy(), v.numpy()) for k, v in want_own.items())
    err_j = max(_max_err(named[k].detach().numpy(), v.numpy())
                for k, v in load_jax_params(_flatten(state_j.params)).items())
    print(f"post-update parameters vs JAX's clip + Adam of the port's gradients: {err_own:.2e}"
          f" (vs JAX's own update: {err_j:.2e})")
    assert err_own <= OPT_TOL
    for k in ("mean", "std"):
        err = _max_err(getattr(net_t.norm, k).numpy(), getattr(state_j.norm, k))
        assert err <= 1e-6 * max(1.0, float(np.abs(getattr(state_j.norm, k)).max())), k
    assert state_t.global_step == int(state_j.global_step) == 1
    assert state_t.head_stats == {} == state_j.head_stats


def test_load_jax_params_both_heads():
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((16, 197)).astype(np.float32)
    acts = {"gauss": rng.standard_normal((16, 36)).astype(np.float32),
            "dis": rng.integers(0, 35, (16, 36)).astype(np.int32)}
    heads = {
        "gauss": (GaussianHead(action_dim=36, init_sigma=0.05),
                  t_heads.GaussianHead(action_dim=36, init_sigma=0.05)),
        "gauss_var": (GaussianHead(action_dim=36, init_sigma=0.1, variabilize_sigma=True),
                      t_heads.GaussianHead(action_dim=36, init_sigma=0.1,
                                           variabilize_sigma=True)),
        "gauss_max": (GaussianHead(action_dim=36, max_sigma=0.5),
                      t_heads.GaussianHead(action_dim=36, max_sigma=0.5)),
        "dis": (CategoricalHead(action_dim=36, bins=35),
                t_heads.CategoricalHead(action_dim=36, bins=35)),
    }
    for name, (hj, ht) in heads.items():
        net_j = ActorCritic(ACConfig(obs_dim=197, head=hj))
        params = net_j.init(jax.random.PRNGKey(5))
        if name == "gauss":   # move the zero-initialized log-sigma layer
            params["head"]["fc_log_sigma"]["w"] = jnp.asarray(
                0.01 * rng.standard_normal((512, 36)), jnp.float32)
        norm = net_j.init_norm()
        flat = _flatten(params)
        flat.update({f"norm/{k}": np.asarray(v) for k, v in norm._asdict().items()})
        net_t = TActorCritic(TACConfig(obs_dim=197, head=ht))
        net_t.load_state_dict(load_jax_params(flat), strict=True)
        back = export_jax_params(net_t)
        assert set(back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        a = acts["dis" if name == "dis" else "gauss"]
        ot = torch.tensor(obs)
        with torch.no_grad():
            got = {"dist": net_t.dist(ot),
                   "act": net_t.act_deterministic(ot),
                   "log_prob": net_t.log_prob(ot, torch.tensor(a)),
                   "entropy": net_t.entropy(ot)}
        want = {"dist": net_j.dist(params, norm, jnp.asarray(obs)),
                "act": net_j.act_deterministic(params, norm, jnp.asarray(obs)),
                "log_prob": net_j.log_prob(params, norm, jnp.asarray(obs), jnp.asarray(a)),
                "entropy": net_j.entropy(params, norm, jnp.asarray(obs))}
        for k in got:
            gs = got[k] if isinstance(got[k], tuple) else (got[k],)
            ws = want[k] if isinstance(want[k], tuple) else (want[k],)
            for g, w in zip(gs, ws):
                w = np.asarray(w)
                err = _max_err(g.numpy(), w) / max(1.0, float(np.abs(w).max()))
                print(f"\nload_jax_params {name} {k}: {err:.2e}", end="")
                assert err <= DIST_TOL, (name, k)
    # the presets' heads as build_head makes them: the discrete preset's
    # wrapped env and 36 x 35 logits; the Gaussian preset's sigma at 0.05
    algo = build_algo(t_build("deepmimic_dppo_dis"), "cpu")
    assert isinstance(algo.env, TWrapper) and algo.env.n == 35
    assert algo.net.head.fc_policy.out_features == 36 * 35
    net = build_algo(t_build("deepmimic_dppo_gauss"), "cpu").net
    net.init_parameters(torch.Generator().manual_seed(0))
    assert float(net.head.fc_log_sigma.weight.detach().abs().max()) == 0.0
    with torch.no_grad():
        sigma = net.dist(torch.tensor(obs))[1]
    torch.testing.assert_close(sigma, torch.full_like(sigma, 0.05), rtol=1e-6, atol=0)
