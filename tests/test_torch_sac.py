"""PyTorch port: one SAC / DDPG gradient step against the JAX package's.

``SAC._update_step`` of both packages from the same parameters, targets,
Adam state, normalizer, particle statistics and batch, at narrow widths
(obs 12, actions 5 on random bounds, trunk and critics of 32, 8 particles,
batch 64), with the JAX package's draws computed from its key and fed to
the port (``update_draws``' layout):

* SAC with the squashed particle head and with the squashed Gaussian head;
* DDPG with the squashed particle head on a gated step (gstep 0: the actor
  loss counts, the target actor stays) and then an ungated one (gstep 1:
  the actor's gradient is zero, Adam moves it by momentum, the target actor
  takes its Polyak step);
* DDPG with the squashed Gaussian head and target smoothing noise.

Held each step: the loss, critic loss, actor loss and alpha (LOSS_RTOL);
every parameter's gradient (GRAD_RTOL of the tensor's largest entry);
every parameter after the clip + Adam step, against JAX's (PARAM_TOL,
three ulps of the step size; Adam's first steps move each entry by about
lr = 1e-4); the targets after Polyak and the normalizer (NORM_TOL); the
step counter and the particle statistics exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos.sac import SAC as TSAC, SACConfig as TSACConfig, SACNet  # noqa: E402
from pfpn_torch.networks import heads as t_heads  # noqa: E402
from pfpn_torch.networks.actor_critic import (  # noqa: E402
    ACConfig as TACConfig, load_jax_params,
)
from pfpn_tpu.algos.sac import SAC, SACConfig  # noqa: E402
from pfpn_tpu.networks import ACConfig, ActorCritic, GaussianHead, ParticleHead  # noqa: E402
from pfpn_tpu.networks import normalizer as jnorm  # noqa: E402

torch.set_num_threads(1)

OBS, ACT, PARTICLES, WIDTH, BATCH = 12, 5, 8, 32, 64
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_TOL = 3e-8
NORM_TOL = 1e-6


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


def _target_flat(target):
    """The JAX package's target tree as the port's target state dict."""
    flat = _flatten({k: target[k] for k in ("q1", "q2")})
    if "actor" in target:
        flat.update(_flatten(target["actor"]))
    return load_jax_params(flat)


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


class Bounds:
    """An env as the clip sees it: its action bounds."""

    def __init__(self, low, high):
        self.action_low, self.action_high = low, high


def _setup(algo, kind, rng):
    low = -rng.uniform(0.5, 2.0, ACT).astype(np.float32)
    high = (low + rng.uniform(1.0, 3.0, ACT)).astype(np.float32)
    bounds = dict(squash=True, action_low=low, action_high=high)
    if kind == "pfpn":
        hj = ParticleHead(action_dim=ACT, particles=PARTICLES, resample=-1,
                          resample_interval=12000, **bounds)
        ht = t_heads.ParticleHead(action_dim=ACT, particles=PARTICLES, resample=-1,
                                  resample_interval=12000, **bounds)
    else:
        hj = GaussianHead(action_dim=ACT, **bounds)
        ht = t_heads.GaussianHead(action_dim=ACT, **bounds)
    shapes = dict(actor_shape=(WIDTH,), critic_shape=(WIDTH,))
    net_j = ActorCritic(ACConfig(obs_dim=OBS, head=hj, **shapes))
    cfg = dict(algo=algo, num_envs=1, batch_size=BATCH)
    sac_j = SAC(Bounds(low, high), net_j, SACConfig(**cfg))
    sac_t = TSAC(Bounds(low, high), SACNet(TACConfig(obs_dim=OBS, head=ht, **shapes), algo),
                 TSACConfig(**cfg))

    # parameters as sac.py:132-142 makes them, moved off their init so that
    # every path carries weight; targets apart from them
    k_a, k_q1, k_q2 = jax.random.split(jax.random.PRNGKey(1), 3)
    params = {k: v for k, v in net_j.init(k_a).items() if k != "critic"}
    params["q1"] = sac_j._init_q(k_q1, OBS, ACT)
    params["q2"] = sac_j._init_q(k_q2, OBS, ACT)
    noise = lambda x, s: x + s * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)  # noqa: E731
    params = jax.tree.map(lambda x: noise(x, 0.1), params)
    if algo == "sac":
        params["log_alpha"] = jnp.asarray(-0.7, jnp.float32)
    target = {"q1": params["q1"], "q2": params["q2"]}
    if algo == "ddpg":
        target["actor"] = {k: params[k] for k in ("actor_trunk", "head")}
    target = jax.tree.map(lambda x: noise(x, 0.02), target)
    norm = jnorm.NormalizerState(jnp.asarray(rng.standard_normal(OBS), jnp.float32),
                                 jnp.asarray(0.5 + rng.random(OBS), jnp.float32),
                                 jnp.asarray(5.0, jnp.float32))
    stats = net_j.init_stats()
    if kind == "pfpn":
        stats = {"max_active": jnp.asarray(rng.random((ACT, PARTICLES)), jnp.float32),
                 "sum_active": jnp.asarray(9 * rng.random((ACT, PARTICLES)), jnp.float32),
                 "train_flag": jnp.asarray(3.0, jnp.float32)}

    flat = _flatten(params)
    flat.update({f"norm/{k}": np.asarray(getattr(norm, k)) for k in norm._fields})
    sac_t.net.load_state_dict(load_jax_params(flat), strict=True)
    sac_t.target.load_state_dict(_target_flat(target), strict=True)
    stats_t = {k: v if k == "train_flag" else torch.tensor(np.asarray(v))
               for k, v in stats.items()}
    if kind == "pfpn":
        stats_t["train_flag"] = 3
    return sac_j, sac_t, params, target, norm, stats, stats_t


def _batch(rng, norm, low, high):
    obs = (np.asarray(norm.mean) + 2 * rng.standard_normal((BATCH, OBS))).astype(np.float32)
    return {"obs": obs,
            "action": (low + (high - low) * rng.random((BATCH, ACT))).astype(np.float32),
            "reward": rng.random(BATCH).astype(np.float32),
            "not_terminal": (rng.random(BATCH) > 0.1).astype(np.float32),
            "next_obs": (obs + 0.3 * rng.standard_normal((BATCH, OBS))).astype(np.float32)}


def _draws(algo, kind, key):
    """The JAX package's noise of one update from its key (sac.py:271,
    :223, :232, :249; heads.py:418-444), in update_draws' layout."""
    k_c, k_a, _ = jax.random.split(key, 3)
    if algo == "ddpg":
        return {"critic": torch.tensor(np.asarray(jax.random.normal(k_c, (BATCH, ACT))))}

    def head_draws(k):
        if kind == "gauss":
            return {"eps": torch.tensor(np.asarray(jax.random.normal(k, (BATCH, ACT))))}
        k1, k2 = jax.random.split(k)
        shape = (BATCH, ACT, PARTICLES)
        return {"gumbel": torch.tensor(np.asarray(jax.random.gumbel(k1, shape))),
                "eps": torch.tensor(np.asarray(jax.random.normal(k2, shape)))}

    return {"critic": head_draws(k_c), "actor": head_draws(k_a)}


@pytest.mark.parametrize("algo,kind,steps", [("sac", "pfpn", 1), ("sac", "gauss", 1),
                                             ("ddpg", "pfpn", 2), ("ddpg", "gauss", 1)],
                         ids=["sac_pfpn", "sac_gauss", "ddpg_pfpn_gated_ungated",
                              "ddpg_gauss_target_noise"])
def test_update_step_matches_jax(algo, kind, steps):
    rng = np.random.default_rng(11)
    sac_j, sac_t, params, target, norm, stats, stats_t = _setup(algo, kind, rng)
    opt_state = sac_j.tx.init(params)
    low, high = sac_j.env.action_low, sac_j.env.action_high
    step_j = jax.jit(sac_j._update_step)

    def total_loss(p, t, n, b, k, g):
        k_c, k_a, _ = jax.random.split(k, 3)
        return (sac_j._critic_loss(p, t, n, b, k_c)[0]
                + sac_j._actor_loss(p, n, b, k_a, g)[0])

    grad_j = jax.jit(jax.grad(total_loss))
    named = dict(sac_t.net.named_parameters())
    print()
    for gstep in range(steps):
        batch = _batch(rng, norm, low, high)
        key = jax.random.PRNGKey(100 + gstep)
        g = jnp.asarray(gstep, jnp.int32)
        grads_j = load_jax_params(_flatten(grad_j(params, target, norm, batch, key, g)))
        params, target, opt_state, norm, stats, g_new, m_j = step_j(
            params, target, opt_state, norm, stats, batch, key, g)

        before = {k: v.clone() for k, v in sac_t.net.state_dict().items()}
        before_t = {k: v.clone() for k, v in sac_t.target.state_dict().items()}
        grads_t = {}
        opt_step = sac_t.opt.step

        def capturing_step():
            grads_t.update({k: p.grad.detach().clone() for k, p in named.items()})
            opt_step()

        sac_t.opt.step = capturing_step
        gstep_t, stats_t, m_t = sac_t._update_step(
            {k: torch.tensor(v) for k, v in batch.items()}, _draws(algo, kind, key), gstep,
            stats_t, torch.Generator().manual_seed(0))
        sac_t.opt.step = opt_step
        tag = f"{algo}-{kind} step {gstep}"
        assert gstep_t == int(g_new) == gstep + 1
        assert sorted(m_t) == sorted(m_j)
        for k in m_j:
            got, want = float(m_t[k]), float(m_j[k])
            print(f"{tag}: {k} port {got:.7g}, JAX {want:.7g}")
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        if algo == "ddpg":
            gated = gstep % 2 == 0
            assert (float(m_j["actor_loss"]) != 0) == gated
        assert set(grads_j) == set(grads_t)
        worst = max(_max_err(grads_t[k], v) / max(float(v.abs().max()), 1e-30)
                    for k, v in grads_j.items() if float(v.abs().max()) > 0)
        print(f"{tag}: gradients, max abs err / max |grad| {worst:.2e}")
        for k, v in grads_j.items():
            scale = float(v.abs().max())
            assert _max_err(grads_t[k], v) <= GRAD_RTOL * scale, k
            if algo == "ddpg" and not gated and not k.startswith("q"):
                assert scale == 0 and float(grads_t[k].abs().max()) == 0, k

        want = load_jax_params(_flatten(params))
        err = {k: _max_err(named[k].detach(), v) for k, v in want.items()}
        print(f"{tag}: parameters after clip + Adam, max abs err {max(err.values()):.2e}")
        for k, e in err.items():
            assert e <= PARAM_TOL, (k, e)
        want_t = _target_flat(target)
        got_t = sac_t.target.state_dict()
        assert set(want_t) == set(got_t)
        err = max(_max_err(got_t[k], v) for k, v in want_t.items())
        print(f"{tag}: targets after Polyak, max abs err {err:.2e}")
        assert err <= NORM_TOL
        for k in ("mean", "std"):
            err = _max_err(getattr(sac_t.net.norm, k), getattr(norm, k))
            print(f"{tag}: normalizer {k} {err:.2e}")
            assert err <= NORM_TOL
        if algo == "ddpg":
            # the actor moves on both steps (by momentum alone on the ungated
            # one); the target actor only after a gated gstep (sac.py:293-298)
            after, after_t = sac_t.net.state_dict(), sac_t.target.state_dict()
            w = "head.fc_policy.weight" if kind == "pfpn" else "head.fc_mu.weight"
            assert not torch.equal(after[w], before[w])
            assert torch.equal(after_t[w], before_t[w]) == gated
        if kind == "pfpn":
            assert stats_t["train_flag"] == float(stats["train_flag"]) == 4 + gstep
            for k in ("max_active", "sum_active"):
                np.testing.assert_array_equal(stats_t[k].numpy(), np.asarray(stats[k]))
