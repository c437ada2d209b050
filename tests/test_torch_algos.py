"""PyTorch port: the learner's building blocks against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's random draws are fed to the port where a function draws.

* ``algos/gae.py``: ``discount`` and ``gae`` on the boundary cases of
  ``tests/test_algos.py:16-50`` (terminal, truncation, unroll end) and on a
  random (T, B) batch with random flags: 1e-6;
* ``distributions/particle.py`` on the shipped Walk policy's head at the
  real shapes (36 x 35): ``log_prob``, ``entropy`` and their gradients with
  respect to the logits, the particle means and the log-stds, rtol 1e-5
  (absolute floor 1e-5 of each tensor's largest value: sums over 36
  dimensions of fp32 logsumexps); the non-finite-cotangent scrub; the draw
  from fed indices and normal draws; the particle init tables, exactly;
* ``networks/normalizer.py``: ``update_moving_average`` and
  ``update_welford``: 1e-6; ``networks/resample.py`` with JAX's draws:
  the dense surgery (source particle, logit bias, logit columns, log-std)
  exactly, particle means to 1e-6, and each dimension's logit mass over the
  living particles unchanged, to 1e-5;
* ``algos/ppo.make_optimizer`` (global-norm clip + Adam) against the JAX
  package's optax chain over three steps on the same synthetic gradients,
  with one group and with separate actor and critic learning rates: 1e-6.

Four tests: pytest-xdist's loadfile schedule hands out files with more
tests first, and this file must not start before ``tests/test_megastep.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos import gae as tgae  # noqa: E402
from pfpn_torch.algos.ppo import PPOConfig as TPPOConfig, make_optimizer as t_make_opt  # noqa: E402
from pfpn_torch.distributions import particle as tpfp  # noqa: E402
from pfpn_torch.networks.actor_critic import (  # noqa: E402
    ACConfig as TACConfig, ActorCritic as TActorCritic, load_jax_params,
)
from pfpn_torch.networks.heads import (  # noqa: E402
    ParticleHead as TParticleHead, ParticleHeadModule, particle_init_tables,
)
from pfpn_torch.networks.normalizer import Normalizer  # noqa: E402
from pfpn_torch.networks.resample import resample_apply  # noqa: E402
from pfpn_tpu.algos import gae as jgae  # noqa: E402
from pfpn_tpu.algos.ppo import PPOConfig, make_optimizer  # noqa: E402
from pfpn_tpu.distributions import particle as jpfp  # noqa: E402
from pfpn_tpu.networks import ACConfig, ActorCritic, ParticleHead  # noqa: E402
from pfpn_tpu.networks import normalizer as jnorm  # noqa: E402
from pfpn_tpu.networks.heads import init_head  # noqa: E402
from pfpn_tpu.networks.resample import resample as j_resample  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results", "policies",
                   "DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz")
GAE_TOL = 1e-6
DIST_RTOL = 1e-5
NORM_TOL = 1e-6
LOC_TOL = 1e-6
MASS_TOL = 1e-5
OPT_TOL = 1e-6


def _flatten(tree, prefix="params"):
    """A JAX params pytree -> the flat ``params/...`` keys of the npz."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = ((f"#{i}", v) for i, v in enumerate(tree))
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
# GAE
# ---------------------------------------------------------------------------

def _gae_both(r, v, vn, term, done, gamma, lam):
    want = np.asarray(jgae.gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(vn),
                               jnp.asarray(term), jnp.asarray(done), gamma, lam))
    got = tgae.gae(torch.tensor(r), torch.tensor(v), torch.tensor(vn),
                   torch.tensor(term), torch.tensor(done), gamma, lam).numpy()
    return got, want


def test_gae_and_discount_match_jax():
    vals = np.array([[1.0], [2.0], [3.0]], np.float32)
    boot = np.array([4.0], np.float32)
    got = tgae.discount(torch.tensor(vals), 0.5, torch.tensor(boot)).numpy()
    want = np.asarray(jgae.discount(jnp.asarray(vals), 0.5, jnp.asarray(boot)))
    np.testing.assert_allclose(got, want, atol=GAE_TOL, rtol=0)

    gamma, lam = 0.9, 0.8
    r = np.ones((3, 1), np.float32)
    v = np.full((3, 1), 0.5, np.float32)
    cases = {
        # a true terminal in the middle: no bootstrap there, the carry is cut
        "terminal": (np.array([[0.5], [0.5], [2.0]], np.float32),
                     np.array([[False], [True], [False]]),
                     np.array([[False], [True], [False]])),
        # truncation: bootstrap with V(next pre-reset state)
        "truncation": (np.array([[0.5], [3.0], [2.0]], np.float32),
                       np.array([[False], [False], [False]]),
                       np.array([[False], [True], [False]])),
        # unroll end only
        "unroll_end": (np.array([[0.5], [0.5], [2.0]], np.float32),
                       np.zeros((3, 1), bool), np.zeros((3, 1), bool)),
    }
    for name, (vn, term, done) in cases.items():
        got, want = _gae_both(r, v, vn, term, done, gamma, lam)
        print(f"\ngae {name}: {_max_err(got, want):.2e}")
        np.testing.assert_allclose(got, want, atol=GAE_TOL, rtol=0, err_msg=name)
    # the terminal case by hand (tests/test_algos.py:24-38)
    got, _ = _gae_both(r, v, *cases["terminal"], gamma, lam)
    d1 = 1.0 - 0.5
    np.testing.assert_allclose(got[1, 0], d1, atol=GAE_TOL)
    np.testing.assert_allclose(got[0, 0], 1 + gamma * 0.5 - 0.5 + gamma * lam * d1,
                               atol=GAE_TOL)

    rng = np.random.default_rng(3)
    T, B = 16, 4
    term = rng.random((T, B)) < 0.1
    done = term | (rng.random((T, B)) < 0.1)
    got, want = _gae_both(rng.standard_normal((T, B)).astype(np.float32),
                          rng.standard_normal((T, B)).astype(np.float32),
                          rng.standard_normal((T, B)).astype(np.float32),
                          term, done, 0.95, 0.95)
    print(f"gae random (16, 4): {_max_err(got, want):.2e}")
    np.testing.assert_allclose(got, want, atol=GAE_TOL, rtol=0)
    tgt, adv = tgae.td_lambda_targets(*(torch.tensor(x) for x in (
        r, v, cases["truncation"][0], cases["truncation"][1], cases["truncation"][2])),
        gamma, lam)
    np.testing.assert_allclose(tgt.numpy(), adv.numpy() + v, atol=GAE_TOL)


# ---------------------------------------------------------------------------
# the particle distribution, at the shipped policy's shapes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def head_inputs():
    """Logits of the shipped policy on 16 observations around its
    normalizer statistics, its particle means and log-stds, and actions:
    draws from each particle mixture plus uniform ones."""
    with np.load(NPZ) as z:
        flat = {k: z[k] for k in z.files}
    net = TActorCritic(TACConfig(obs_dim=197, head=TParticleHead(action_dim=36, particles=35)))
    net.load_state_dict(load_jax_params(flat), strict=True)
    rng = np.random.default_rng(21)
    obs = (flat["norm/mean"] + flat["norm/std"] * rng.standard_normal((16, 197))).astype(np.float32)
    with torch.no_grad():
        logits = net.dist(torch.tensor(obs))[0].numpy()
    loc = net.head.particles.detach().numpy()
    log_std = net.head.particles_log_std.detach().numpy()
    idx = rng.integers(0, 35, size=(8, 36))
    near = loc[np.arange(36), idx] + np.exp(log_std[np.arange(36), idx]) * rng.standard_normal((8, 36))
    actions = np.concatenate([near, rng.uniform(-1.5, 1.5, (8, 36))]).astype(np.float32)
    return logits, loc, log_std, actions


def _jax_terms(logits, loc, log_std, actions, w):
    def f(lg, lo, ls):
        lp = jpfp.log_prob(lg, lo, jnp.exp(jnp.clip(ls, -20.0, 2.0)), jnp.asarray(actions))
        return jnp.sum(lp * w), lp

    (_, lp), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(loc), jnp.asarray(log_std))
    ent, ent_grad = jax.jit(jax.value_and_grad(
        lambda lg: jnp.sum(jpfp.entropy(lg) * w[:, None])))(jnp.asarray(logits))
    return (np.asarray(lp), [np.asarray(g) for g in grads],
            np.asarray(jpfp.entropy(jnp.asarray(logits))), np.asarray(ent_grad))


def _torch_terms(logits, loc, log_std, actions, w):
    lg, lo, ls = (torch.tensor(x, requires_grad=True) for x in (logits, loc, log_std))
    lp = tpfp.log_prob(lg, lo, torch.exp(torch.clamp(ls, -20.0, 2.0)), torch.tensor(actions))
    torch.sum(lp * torch.tensor(w)).backward()
    lg2 = torch.tensor(logits, requires_grad=True)
    ent = tpfp.entropy(lg2)
    torch.sum(ent * torch.tensor(w)[:, None]).backward()
    return (lp.detach().numpy(), [x.grad.numpy() for x in (lg, lo, ls)],
            ent.detach().numpy(), lg2.grad.numpy())


def _close(got, want, what):
    err = _max_err(got, want)
    scale = float(np.abs(want).max())
    print(f"{what}: max abs err {err:.2e} (max |value| {scale:.3g})")
    np.testing.assert_allclose(got, want, rtol=DIST_RTOL, atol=DIST_RTOL * scale,
                               err_msg=what)


def test_particle_distribution_matches_jax(head_inputs):
    logits, loc, log_std, actions = head_inputs
    w = np.random.default_rng(5).standard_normal(actions.shape[0]).astype(np.float32)
    got = _torch_terms(logits, loc, log_std, actions, w)
    want = _jax_terms(logits, loc, log_std, actions, w)
    print()
    _close(got[0], want[0], "log_prob")
    for name, g, wg in zip(("logits", "particle means", "log-stds"), got[1], want[1]):
        _close(g, wg, f"d log_prob / d {name}")
    _close(got[2], want[2], "entropy")
    _close(got[3], want[3], "d entropy / d logits")

    # the scrub: exp(-log_prob) of a far-away action overflows, so its
    # cotangent is -inf; both packages zero it, and that sample adds nothing
    far = actions.copy()
    far[0, 0] = 1e3
    wf = np.ones(actions.shape[0], np.float32)

    def j_obj(lg, lo, ls, acts):
        lp = jpfp.log_prob(lg, lo, jnp.exp(jnp.clip(ls, -20.0, 2.0)), acts)
        return jnp.sum(wf[: acts.shape[0]] * jnp.exp(-lp * 1e-5))

    j_grad = jax.jit(jax.grad(j_obj, argnums=(0, 1, 2)))
    j_far = j_grad(logits, loc, log_std, jnp.asarray(far))
    lg, lo, ls = (torch.tensor(x, requires_grad=True) for x in (logits, loc, log_std))
    lp = tpfp.log_prob(lg, lo, torch.exp(torch.clamp(ls, -20.0, 2.0)), torch.tensor(far))
    torch.sum(torch.exp(-lp * 1e-5)).backward()
    assert float(lp[0].detach()) * -1e-5 > 89.0     # exp overflows in fp32
    # without the far-away sample (its logits row zeroed in the gradient)
    j_rest = j_grad(logits[1:], loc, log_std, jnp.asarray(far[1:]))
    for name, t_g, j_g, j_r in zip(("logits", "particle means", "log-stds"),
                                    (lg.grad, lo.grad, ls.grad), j_far, j_rest):
        t_g, j_g, j_r = t_g.numpy(), np.asarray(j_g), np.asarray(j_r)
        assert np.isfinite(t_g).all() and np.isfinite(j_g).all(), name
        if name == "logits":
            np.testing.assert_array_equal(t_g[0], 0.0)
            np.testing.assert_array_equal(j_g[0], 0.0)
            t_g, j_g = t_g[1:], j_g[1:]
        _close(t_g, j_g, f"scrubbed d / d {name}")
        _close(t_g, j_r, f"scrubbed d / d {name}, against JAX without the sample")

    # the draw from JAX's particle indices and normal draws (particle.py:94)
    key = jax.random.PRNGKey(7)
    j_a, j_idx = jpfp.sample(key, jnp.asarray(logits), jnp.asarray(loc),
                             jnp.exp(jnp.asarray(log_std)))
    eps = np.asarray(jax.random.normal(jax.random.split(key)[1], j_idx.shape))
    t_a = tpfp.sample_from(torch.tensor(loc), torch.exp(torch.tensor(log_std)),
                           torch.tensor(np.asarray(j_idx), dtype=torch.long), torch.tensor(eps))
    np.testing.assert_allclose(t_a.numpy(), np.asarray(j_a), rtol=0, atol=1e-6)

    # the non-squashed particle grid (heads.py:111-141), exactly
    for cfg_kw in ({}, {"init_sigma": 0.05}):
        cfg = ParticleHead(action_dim=36, particles=35, **cfg_kw)
        j = init_head(jax.random.PRNGKey(0), cfg, 512)
        t_loc, t_ls = particle_init_tables(TParticleHead(action_dim=36, particles=35, **cfg_kw))
        np.testing.assert_array_equal(t_loc, np.asarray(j["particles"]))
        np.testing.assert_array_equal(t_ls, np.asarray(j["particles_log_std"]))
    t_head = ParticleHeadModule(TParticleHead(action_dim=36, particles=35), 512)
    t_head.init_parameters(torch.Generator().manual_seed(0))
    w = t_head.fc_policy.weight.detach()
    assert float(w.abs().max()) <= 0.02 and float(t_head.fc_policy.bias.detach().abs().max()) == 0
    assert 0.0075 < float(w.std()) < 0.0095   # truncated at 2 sigma: 0.88 sigma


# ---------------------------------------------------------------------------
# normalizer and resampling
# ---------------------------------------------------------------------------

def test_normalizer_and_resample_match_jax(head_inputs):
    rng = np.random.default_rng(9)
    mean = rng.standard_normal(197).astype(np.float32)
    std = (0.5 + rng.random(197)).astype(np.float32)
    batch = (3.0 * rng.standard_normal((256, 197)) + 1.0).astype(np.float32)
    state = jnorm.NormalizerState(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(7.0))
    for step in (1, 17, 500000):
        want = jnorm.update_moving_average(state, jnp.asarray(batch), jnp.asarray(step))
        t = Normalizer((197,))
        t.mean.copy_(torch.tensor(mean))
        t.std.copy_(torch.tensor(std))
        t.update_moving_average(torch.tensor(batch), step)
        for k in ("mean", "std"):
            err = _max_err(getattr(t, k).numpy(), getattr(want, k))
            print(f"\nupdate_moving_average, step {step}, {k}: {err:.2e}")
            assert err <= NORM_TOL, (step, k)
    want = jnorm.update_welford(state, jnp.asarray(batch))
    t = Normalizer((197,))
    t.mean.copy_(torch.tensor(mean))
    t.std.copy_(torch.tensor(std))
    t.count.fill_(7.0)
    t.update_welford(torch.tensor(batch))
    for k in ("mean", "std", "count"):
        err = _max_err(getattr(t, k).numpy(), getattr(want, k))
        print(f"update_welford, {k}: {err:.2e}")
        assert err <= NORM_TOL * max(1.0, float(np.abs(getattr(want, k)).max())), k

    # resampling: the shipped head, statistics with dead particles, JAX's draws
    with np.load(NPZ) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files if k.startswith("params/head/")}
    d, n = 36, 35
    cfg = ParticleHead(action_dim=d, particles=n, resample=-1)
    jparams = {"fc_policy": {"w": jnp.asarray(flat["params/head/fc_policy/w"]),
                             "b": jnp.asarray(flat["params/head/fc_policy/b"])},
               "particles": jnp.asarray(flat["params/head/particles"]),
               "particles_log_std": jnp.asarray(flat["params/head/particles_log_std"])}
    max_active = rng.random((d, n)).astype(np.float32)
    max_active[rng.random((d, n)) < 0.3] = 1e-4                 # dead: below 0.05 / 35
    sum_active = (rng.random((d, n)) * max_active * 50).astype(np.float32)
    jstats = {"max_active": jnp.asarray(max_active), "sum_active": jnp.asarray(sum_active),
              "train_flag": jnp.zeros(())}
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, s_, k: j_resample(cfg, p, s_, k))(jparams, jstats, key)
    # the draws of resample.py:49-62, from the same key splits
    total = jnp.sum(jstats["sum_active"], axis=1, keepdims=True)
    avg = jnp.where(total > 0, jstats["sum_active"] / jnp.maximum(total, 1e-12), 1.0 / n)
    k1, k2 = jax.random.split(key)
    cand = jax.random.categorical(k1, jnp.log(jnp.maximum(avg, 1e-12)), axis=-1,
                                  shape=(n, d)).T
    u = jax.random.uniform(k2, (d, n), minval=-1.0, maxval=1.0)

    head = ParticleHeadModule(TParticleHead(action_dim=d, particles=n), 512)
    sd = load_jax_params({k: v for k, v in flat.items()})
    head.load_state_dict({k[len("head."):]: v for k, v in sd.items()})
    feat = torch.nn.functional.relu6(torch.tensor(rng.standard_normal((8, 512)).astype(np.float32)))
    with torch.no_grad():
        before = head.dist(feat)[0]
    tstats = {"max_active": torch.tensor(max_active), "sum_active": torch.tensor(sum_active),
              "train_flag": 0}
    tgt = resample_apply(TParticleHead(action_dim=d, particles=n, resample=-1), head, tstats,
                         torch.tensor(np.asarray(cand), dtype=torch.long),
                         torch.tensor(np.asarray(u)))
    invalid = max_active < 0.05 / n
    assert 0 < invalid.sum() < invalid.size
    np.testing.assert_array_equal(tgt.numpy(),
                                  np.where(invalid, np.asarray(cand), np.arange(n)[None]))
    # the logit bias b - log(count + 1): equal, except where XLA's fp32 log
    # is not correctly rounded (log(7) is one ulp off on the CPU) and
    # torch.log is; there it is one ulp apart
    t_b = head.fc_policy.bias.detach().numpy().reshape(d, n)
    j_b = np.asarray(want["fc_policy"]["b"]).reshape(d, n)
    tg = tgt.numpy()
    count = np.zeros((d, n), np.float32)
    for i in range(d):
        np.add.at(count[i], tg[i], invalid[i].astype(np.float32))
    arg = count + 1.0 - invalid                    # the log's argument per particle
    arg = np.where(invalid, arg[np.arange(d)[:, None], tg], arg)   # dead slots copy
    off = t_b != j_b
    np.testing.assert_array_max_ulp(t_b, j_b, maxulp=1)
    exact_log = np.log(arg.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.log(jnp.asarray(arg[off]))) != exact_log[off],
                                  True)
    print(f"\nresample: logit bias equal but {int(off.sum())} of {off.size}, one ulp off "
          f"where XLA's log of {sorted(set(arg[off].tolist()))} is not correctly rounded")
    np.testing.assert_array_equal(head.fc_policy.weight.detach().numpy().T,
                                  np.asarray(want["fc_policy"]["w"]))
    np.testing.assert_array_equal(head.particles_log_std.detach().numpy(),
                                  np.asarray(want["particles_log_std"]))
    err = _max_err(head.particles.detach().numpy(), want["particles"])
    print(f"resample: particle means {err:.2e}; {int(invalid.sum())} of {invalid.size} "
          "slots resampled")
    assert err <= LOC_TOL
    # each dimension's logit mass over the living particles is preserved
    with torch.no_grad():
        after = head.dist(feat)[0]
    alive = torch.tensor(~invalid)
    m_before = torch.logsumexp(torch.where(alive, before, -torch.inf), -1)
    m_after = torch.logsumexp(after, -1)
    err = float((m_after - m_before).abs().max())
    print(f"resample: log of the logit mass per dimension {err:.2e}")
    assert err <= MASS_TOL


# ---------------------------------------------------------------------------
# clip + Adam
# ---------------------------------------------------------------------------

def test_optimizer_matches_optax():
    acfg = dict(obs_dim=6, actor_shape=(16,), critic_shape=(16,))
    net_j = ActorCritic(ACConfig(head=ParticleHead(action_dim=3, particles=5), **acfg))
    rng = np.random.default_rng(13)
    for lr_actor, lr_critic in ((1e-4, 1e-4), (1e-4, 3e-4)):
        params = net_j.init(jax.random.PRNGKey(1))
        net_t = TActorCritic(TACConfig(head=TParticleHead(action_dim=3, particles=5), **acfg))
        net_t.load_state_dict(load_jax_params(_flatten(params)), strict=False)
        tx = make_optimizer(PPOConfig(lr_actor=lr_actor, lr_critic=lr_critic, norm_clip=1.0))
        opt_state = tx.init(params)
        tx_update = jax.jit(tx.update)
        opt = t_make_opt(TPPOConfig(lr_actor=lr_actor, lr_critic=lr_critic, norm_clip=1.0),
                         net_t)
        named = dict(net_t.named_parameters())
        for step, scale in enumerate((0.3, 0.01, 0.3)):   # clipped, not, clipped
            grads = jax.tree.map(
                lambda x: jnp.asarray(scale * rng.standard_normal(x.shape), jnp.float32),
                params)
            updates, opt_state = tx_update(grads, opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
            opt.zero_grad()
            for name, g in load_jax_params(_flatten(grads)).items():
                named[name].grad = g.clone()
            opt.step()
            want = load_jax_params(_flatten(params))
            err = max(_max_err(named[k].detach().numpy(), v.numpy()) for k, v in want.items())
            print(f"\nclip + Adam, lr {lr_actor:g}/{lr_critic:g}, step {step + 1}: {err:.2e}")
            assert err <= OPT_TOL
