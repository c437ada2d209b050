"""PyTorch port: the tanh-squashed particle and Gaussian paths against JAX.

The same inputs, made with numpy from a seed (logits at the scale of a
trained head, the shipped SAC + PFPN-35 policy's particle means and
log-stds in atanh space), and the same draws: the JAX package's Gumbel and
normal noise, computed from its key, fed to the port's deterministic half
(``rsample_squashed_from``, a head's ``sample_with_log_prob`` with
``draws``):

* ``rsample_squashed``'s action and pre-tanh value, and the vector-Jacobian
  product of both and of the squashed ``log_prob`` (given ``pre_tanh``, as
  SAC's actor loss takes it) to the logits, particle means and log-stds,
  through the straight-through picks' custom gradients; the squashed
  ``log_prob`` of given actions (atanh inside), values and gradients;
* the squashed ``mode``'s value and its gradient to the logits and means
  (DDPG's actor path), in the same test;
* both heads' squashed ``sample_with_log_prob``, ``log_prob_of`` and
  ``deterministic_action`` on the env's bounds, and both squashed particle
  grids, with and without ``init_sigma``;
* the squashed fixed-sigma resample (jitter in tanh space).

Values to 1e-5 of their largest magnitude (VAL_RTOL), gradients to 1e-5
of each tensor's largest entry (GRAD_RTOL); grids and the resample to fp32
rounding (1e-6).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.distributions import particle as tpfp  # noqa: E402
from pfpn_torch.networks import heads as t_heads  # noqa: E402
from pfpn_torch.networks.resample import resample_apply  # noqa: E402
from pfpn_tpu.distributions import particle as jpfp  # noqa: E402
from pfpn_tpu.networks import heads as j_heads  # noqa: E402
from pfpn_tpu.networks.resample import resample as j_resample  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAC_NPZ = os.path.join(ROOT, "results", "policies",
                       "DeepMimicWalk-v0_deepmimic_sac_pfpn_particle35_34114_step11138592.npz")
VAL_RTOL = 1e-5
GRAD_RTOL = 1e-5
GRID_TOL = 1e-6
B, D, N = 16, 36, 35


def _close(got, want, what, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"{what}: max abs err {err:.2e} (max |value| {scale:.3g})")
    assert got.shape == want.shape, what
    assert err <= rtol * max(scale, 1e-30), what


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    with np.load(SAC_NPZ) as z:
        loc = z["params/head/particles"].astype(np.float32)
        log_std = z["params/head/particles_log_std"].astype(np.float32)
    logits = (3.0 * rng.standard_normal((B, D, N))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    gumbel = np.asarray(jax.random.gumbel(k1, (B, D, N)))
    eps = np.asarray(jax.random.normal(k2, (B, D, N)))
    return logits, loc, log_std, key, gumbel, eps, rng


def test_rsample_log_prob_and_mode_squashed_match_jax(inputs):
    logits, loc, log_std, key, gumbel, eps, rng = inputs
    w_a, w_p, w_l = (rng.standard_normal(s).astype(np.float32) for s in ((B, D), (B, D), B))

    def j_f(lg, lo, ls):
        a, pre = jpfp.rsample_squashed(key, lg, lo, jnp.exp(jnp.clip(ls, -20.0, 2.0)))
        lp = jpfp.log_prob(lg, lo, jnp.exp(jnp.clip(ls, -20.0, 2.0)), a, squash=True,
                           pre_tanh=pre)
        return jnp.sum(a * w_a) + jnp.sum(pre * w_p) + jnp.sum(lp * w_l), (a, pre, lp)

    (_, (a_j, pre_j, lp_j)), g_j = jax.jit(jax.value_and_grad(
        j_f, argnums=(0, 1, 2), has_aux=True))(logits, loc, log_std)

    lg, lo, ls = (torch.tensor(x, requires_grad=True) for x in (logits, loc, log_std))
    scale = torch.exp(torch.clamp(ls, -20.0, 2.0))
    a_t, pre_t = tpfp.rsample_squashed_from(lg, lo, scale, torch.tensor(gumbel),
                                            torch.tensor(eps))
    lp_t = tpfp.log_prob(lg, lo, scale, a_t, squash=True, pre_tanh=pre_t)
    (torch.sum(a_t * torch.tensor(w_a)) + torch.sum(pre_t * torch.tensor(w_p))
     + torch.sum(lp_t * torch.tensor(w_l))).backward()
    print()
    _close(a_t.detach(), a_j, "rsample_squashed action", VAL_RTOL)
    _close(pre_t.detach(), pre_j, "rsample_squashed pre-tanh", VAL_RTOL)
    _close(lp_t.detach(), lp_j, "squashed log_prob given pre_tanh", VAL_RTOL)
    for name, t, g in zip(("logits", "loc", "log_std"), (lg, lo, ls), g_j):
        _close(t.grad, g, f"VJP to {name}", GRAD_RTOL)

    # the log-prob of given actions in (-1, 1), atanh taken inside; some at
    # the clip
    act = np.tanh(loc[np.arange(D), rng.integers(0, N, (B, D))]
                  + 0.3 * rng.standard_normal((B, D))).astype(np.float32)
    act[0, :4] = [1.0, -1.0, 0.9999999, -0.9999999]

    def j_g(lg, lo, ls):
        lp = jpfp.log_prob(lg, lo, jnp.exp(jnp.clip(ls, -20.0, 2.0)), act, squash=True)
        return jnp.sum(lp * w_l), lp

    (_, lp2_j), g2_j = jax.jit(jax.value_and_grad(j_g, argnums=(0, 1, 2), has_aux=True))(
        logits, loc, log_std)
    lg, lo, ls = (torch.tensor(x, requires_grad=True) for x in (logits, loc, log_std))
    lp2_t = tpfp.log_prob(lg, lo, torch.exp(torch.clamp(ls, -20.0, 2.0)), torch.tensor(act),
                          squash=True)
    torch.sum(lp2_t * torch.tensor(w_l)).backward()
    _close(lp2_t.detach(), lp2_j, "squashed log_prob of actions", VAL_RTOL)
    for name, t, g in zip(("logits", "loc", "log_std"), (lg, lo, ls), g2_j):
        _close(t.grad, g, f"squashed log_prob gradient to {name}", GRAD_RTOL)

    # the squashed mode, DDPG's actor path
    w = w_a

    def j_f(lg, lo):
        m = jpfp.mode(lg, lo, squash=True)
        return jnp.sum(m * w), m

    (_, m_j), g_j = jax.jit(jax.value_and_grad(j_f, argnums=(0, 1), has_aux=True))(logits, loc)
    lg, lo = (torch.tensor(x, requires_grad=True) for x in (logits, loc))
    m_t = tpfp.mode(lg, lo, squash=True)
    torch.sum(m_t * torch.tensor(w)).backward()
    _close(m_t.detach(), m_j, "squashed mode", VAL_RTOL)
    for name, t, g in zip(("logits", "loc"), (lg, lo), g_j):
        _close(t.grad, g, f"squashed mode gradient to {name}", GRAD_RTOL)
    np.testing.assert_array_equal(tpfp.mode(torch.tensor(logits), torch.tensor(loc)).numpy(),
                                  np.asarray(jpfp.mode(logits, loc)))


def _bounds(rng):
    low = -rng.uniform(0.5, 3.0, D).astype(np.float32)
    return low, (low + rng.uniform(0.5, 4.0, D)).astype(np.float32)


@pytest.mark.parametrize("kind", ["particle", "gaussian"])
def test_squashed_heads_and_grids_match_jax(inputs, kind):
    _, _, _, _, _, _, rng = inputs
    low, high = _bounds(rng)
    feat_dim = 24
    feat = rng.standard_normal((B, feat_dim)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    if kind == "particle":
        # both squashed grids, with and without init_sigma, from init_head
        for init_sigma in (None, 0.1, 0.4):
            jc = j_heads.ParticleHead(action_dim=D, particles=N, squash=True,
                                      init_sigma=init_sigma)
            jp = j_heads.init_head(key, jc, feat_dim)
            tloc, tls = t_heads.particle_init_tables(
                t_heads.ParticleHead(action_dim=D, particles=N, squash=True,
                                     init_sigma=init_sigma))
            _close(tloc, jp["particles"], f"squashed grid means, init_sigma {init_sigma}",
                   GRID_TOL)
            _close(tls, jp["particles_log_std"],
                   f"squashed grid log-stds, init_sigma {init_sigma}", GRID_TOL)
        jc = j_heads.ParticleHead(action_dim=D, particles=N, squash=True,
                                  action_low=low, action_high=high)
        tc = t_heads.ParticleHead(action_dim=D, particles=N, squash=True,
                                  action_low=low, action_high=high)
        k1, k2 = jax.random.split(key)
        draws = {"gumbel": jax.random.gumbel(k1, (B, D, N)),
                 "eps": jax.random.normal(k2, (B, D, N))}
    else:
        jc = j_heads.GaussianHead(action_dim=D, squash=True, action_low=low, action_high=high)
        tc = t_heads.GaussianHead(action_dim=D, squash=True, action_low=low, action_high=high)
        draws = {"eps": jax.random.normal(key, (B, D))}
    jp = j_heads.init_head(jax.random.PRNGKey(5), jc, feat_dim)
    # weights at a trained head's scale, so that the picks and the tanh matter
    jp = jax.tree.map(lambda x: x + 0.3 * jnp.asarray(rng.standard_normal(x.shape),
                                                      jnp.float32), jp)
    head = t_heads.head_module(tc, feat_dim)
    with torch.no_grad():
        for name, p in head.named_parameters():
            parts = name.split(".")
            v = np.asarray(jp[parts[0]][{"weight": "w", "bias": "b"}[parts[1]]]).T \
                if len(parts) == 2 else np.asarray(jp[name])
            p.copy_(torch.tensor(np.ascontiguousarray(v)))

    a_j, lp_j, aux_j = j_heads.sample_with_log_prob(jc, jp, jnp.asarray(feat), key)
    a_t, lp_t, aux_t = head.sample_with_log_prob(
        torch.tensor(feat), None, {k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    print()
    _close(a_t.detach(), a_j, f"{kind}: squashed draw on the bounds", VAL_RTOL)
    _close(lp_t.detach(), lp_j, f"{kind}: its log-prob", VAL_RTOL)
    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        _close(aux_t[k].detach(), aux_j[k], f"{kind}: aux {k}", VAL_RTOL)
    # on the bounds, to the rounding of scale * tanh + offset where tanh is +-1
    assert (a_t >= torch.tensor(low) - 1e-6).all() and (a_t <= torch.tensor(high) + 1e-6).all()
    inside = (low + (high - low) * rng.uniform(0.02, 0.98, (B, D))).astype(np.float32)
    _close(head.log_prob_of(torch.tensor(feat), torch.tensor(inside)).detach(),
           j_heads.log_prob_of(jc, jp, jnp.asarray(feat), jnp.asarray(inside)),
           f"{kind}: log_prob_of actions on the bounds", VAL_RTOL)
    _close(head.deterministic_action(torch.tensor(feat)).detach(),
           j_heads.deterministic_action(jc, jp, jnp.asarray(feat)),
           f"{kind}: deterministic action on the bounds", VAL_RTOL)
    _close(t_heads.normalize_action(tc, torch.tensor(inside)),
           j_heads.normalize_action(jc, jnp.asarray(inside)), f"{kind}: normalize_action",
           GRID_TOL)


def test_squashed_fixed_sigma_resample_matches_jax(inputs):
    _, _, _, _, _, _, rng = inputs
    d, n, feat_dim = D, N, 16
    jc = j_heads.ParticleHead(action_dim=d, particles=n, squash=True, fixed_sigma=True,
                              init_sigma=0.2, resample=-1)
    jp = j_heads.init_head(jax.random.PRNGKey(2), jc, feat_dim)
    jp = {**jp, "particles": jp["particles"]
          + 0.2 * jnp.asarray(rng.standard_normal((d, n)), jnp.float32)}
    max_active = rng.random((d, n)).astype(np.float32)
    max_active[rng.random((d, n)) < 0.4] = 1e-4                  # dead: below 0.05 / 35
    sum_active = (rng.random((d, n)) * max_active * 50).astype(np.float32)
    jstats = {"max_active": jnp.asarray(max_active), "sum_active": jnp.asarray(sum_active),
              "train_flag": jnp.zeros(())}
    key = jax.random.PRNGKey(17)
    want = jax.jit(lambda p, s_, k: j_resample(jc, p, s_, k))(jp, jstats, key)
    # the draws of resample.py:49-62, from the same key splits
    total = jnp.sum(jstats["sum_active"], axis=1, keepdims=True)
    avg = jnp.where(total > 0, jstats["sum_active"] / jnp.maximum(total, 1e-12), 1.0 / n)
    k1, k2 = jax.random.split(key)
    cand = jax.random.categorical(k1, jnp.log(jnp.maximum(avg, 1e-12)), axis=-1,
                                  shape=(n, d)).T
    u = jax.random.uniform(k2, (d, n), minval=-1.0, maxval=1.0)

    tc = t_heads.ParticleHead(action_dim=d, particles=n, squash=True, fixed_sigma=True,
                              init_sigma=0.2, resample=-1)
    head = t_heads.head_module(tc, feat_dim)
    with torch.no_grad():
        head.fc_policy.weight.copy_(torch.tensor(np.asarray(jp["fc_policy"]["w"]).T))
        head.fc_policy.bias.copy_(torch.tensor(np.asarray(jp["fc_policy"]["b"])))
        head.particles.copy_(torch.tensor(np.asarray(jp["particles"])))
        head.particles_log_std_fixed.copy_(torch.tensor(np.asarray(
            jp["particles_log_std_fixed"])))
    tstats = {"max_active": torch.tensor(max_active), "sum_active": torch.tensor(sum_active),
              "train_flag": 0}
    resample_apply(tc, head, tstats, torch.tensor(np.asarray(cand), dtype=torch.long),
                   torch.tensor(np.asarray(u)))
    invalid = max_active < 0.05 / n
    assert 0 < invalid.sum() < invalid.size
    print()
    _close(head.particles.detach(), want["particles"],
           f"squashed fixed-sigma resample, particle means ({int(invalid.sum())} moved)",
           GRID_TOL)
    np.testing.assert_array_equal(head.particles_log_std_fixed.numpy(),
                                  np.asarray(want["particles_log_std_fixed"]))
    np.testing.assert_array_equal(head.fc_policy.weight.detach().numpy().T,
                                  np.asarray(want["fc_policy"]["w"]))
    np.testing.assert_array_max_ulp(head.fc_policy.bias.detach().numpy(),
                                    np.asarray(want["fc_policy"]["b"]), maxulp=1)
