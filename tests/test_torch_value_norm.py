"""PyTorch port: value normalization and the straight-through value clip
against JAX.

* ``networks/value_norm.py`` (``init``, ``update`` over five optimizer
  steps, ``denormalize`` and ``normalize_target`` with and without the
  clip) and ``clip_with_gradient`` (value and gradient) against JAX's
  (1e-6 relative); the actor-critic's ``raw_value``, ``normalized_value``
  and ``value`` at full width with a value normalizer, with the clip on,
  and with the clip alone (which JAX's ``value`` also applies);
* one PPO update (``deepmimic_dppo_pfpn``, 32 steps x 8 envs) and one A2C
  update (``deepmimic_a3c_pfpn``, 32 x 16), each one minibatch, at full
  width (the shipped Walk DPPO + PFPN-35 policy's parameters) with
  ``normalize_value=True, clip_value=5.0`` from a value normalizer away
  from the identity, so that both clips engage: the loss (rtol 1e-5), every
  parameter's gradient (5e-5 of the tensor's largest entry), the
  parameters after it against JAX's clip + Adam of the port's gradients
  (1e-6), and the value normalizer after the update against JAX's (1e-6
  relative);
* ``build_algo`` refusing exactly the configurations that JAX's refuses
  (value normalization off the feed-forward PPO and A2C paths), and a
  checkpoint written without ``vnorm`` and ``carry`` restoring, those
  fields keeping the template's values.

``-s`` prints every error. Four tests, so that pytest-xdist's loadfile
schedule does not start this file before ``tests/test_megastep.py``.
"""

import dataclasses
import importlib
import itertools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos.a2c import A2C as TA2C  # noqa: E402
from pfpn_torch.algos.ppo import PPO as TPPO, PPOConfig as TPPOConfig, PPOState  # noqa: E402
from pfpn_torch.harness import build as t_build_mod, settings  # noqa: E402
from pfpn_torch.harness.checkpoint import CheckpointManager  # noqa: E402
from pfpn_torch.networks import value_norm as t_vnorm  # noqa: E402
from pfpn_torch.networks.actor_critic import clip_with_gradient, load_jax_params  # noqa: E402
from pfpn_tpu.algos.a2c import A2C  # noqa: E402
from pfpn_tpu.algos.gae import gae as j_gae  # noqa: E402
from pfpn_tpu.algos.ppo import PPO, PPOConfig, PPOState as JPPOState  # noqa: E402
from pfpn_tpu.harness.settings import build as j_build  # noqa: E402
from pfpn_tpu.networks import value_norm as j_vnorm  # noqa: E402
from pfpn_tpu.networks.actor_critic import _clip_with_gradient  # noqa: E402

# pfpn_tpu.harness exports a function of the module's name
j_build_mod = importlib.import_module("pfpn_tpu.harness.build")

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results", "policies",
                   "DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz")
REL_TOL = 1e-6
LOSS_RTOL = 1e-5      # tests/test_torch_train.py's bounds
GRAD_TOL = 5e-5
OPT_TOL = 1e-6
CLIP_VALUE = 5.0
# a value normalizer away from the identity: the npz critic's outputs (~4-9)
# and their targets land beyond the clip of 5 on either side of it
VNORM = dict(mean=2.0, std=0.8, scale=0.9, offset=0.3)


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


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


class StubEnv:
    """What build_head and build_net read of an env: its sizes and bounds."""

    observation_size, action_size = 197, 36
    action_low, action_high = -np.ones(36, np.float32), np.ones(36, np.float32)
    device = torch.device("cpu")


def _cfgs(setting, **network):
    cfg_j, cfg_t = j_build(setting, particles=35), settings.build(setting, particles=35)
    return tuple(dataclasses.replace(c, network=dataclasses.replace(c.network, **network))
                 for c in (cfg_j, cfg_t))


def _npz_nets(setting, **network):
    """Both packages' networks of a preset with the shipped npz's parameters."""
    cfg_j, cfg_t = _cfgs(setting, **network)
    net_j = j_build_mod.build_net(cfg_j, StubEnv())
    net_t = t_build_mod.build_net(cfg_t, StubEnv())
    with np.load(NPZ) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    net_t.load_state_dict(load_jax_params(flat), strict=True)
    params = _unflatten({k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()
                         if k.startswith("params/")})
    norm = net_j.init_norm()._replace(mean=jnp.asarray(flat["norm/mean"]),
                                      std=jnp.asarray(flat["norm/std"]))
    return cfg_j, net_j, net_t, params, norm


def _vnorms():
    j = j_vnorm.ValueNormState(**{k: jnp.asarray(v, jnp.float32) for k, v in VNORM.items()})
    t = t_vnorm.ValueNormState(**{k: torch.tensor(v, dtype=torch.float32)
                                  for k, v in VNORM.items()})
    return j, t


def test_value_norm_and_clip_match_jax():
    rng = np.random.default_rng(11)
    state_j, state_t = j_vnorm.init(), t_vnorm.init()
    for step in range(1, 6):
        targets = (3.0 + 2.0 * step + 4.0 * rng.standard_normal(256)).astype(np.float32)
        state_j = j_vnorm.update(state_j, jnp.asarray(targets), jnp.asarray(step, jnp.int32))
        state_t = t_vnorm.update(state_t, torch.tensor(targets), step)
        errs = {k: _rel_err(getattr(state_t, k).numpy(), getattr(state_j, k))
                for k in state_j._fields}
        print(f"\nvalue_norm.update, step {step}: {errs}", end="")
        assert max(errs.values()) <= REL_TOL, errs
        assert all(getattr(state_t, k).shape == () for k in state_t._fields)
    raw = (5.0 * rng.standard_normal(512)).astype(np.float32)
    for clip in (None, CLIP_VALUE):
        for name, got, want in (
                ("denormalize", t_vnorm.denormalize(state_t, torch.tensor(raw), clip),
                 j_vnorm.denormalize(state_j, jnp.asarray(raw), clip)),
                ("normalize_target", t_vnorm.normalize_target(state_t, torch.tensor(raw), clip),
                 j_vnorm.normalize_target(state_j, jnp.asarray(raw), clip))):
            err = _rel_err(got.numpy(), want)
            print(f"\nvalue_norm.{name}, clip {clip}: {err:.2e} of max(1, |value|)", end="")
            assert err <= REL_TOL, (name, clip)

    # the straight-through clip: a hard clip forward, the identity backward
    x = (4.0 * rng.standard_normal(1000)).astype(np.float32)
    w = rng.standard_normal(1000).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    yt = clip_with_gradient(xt, -CLIP_VALUE, CLIP_VALUE)
    (yt * torch.tensor(w)).sum().backward()
    def clipped_sum(v):
        return jnp.sum(_clip_with_gradient(v, -CLIP_VALUE, CLIP_VALUE) * w)

    yj = _clip_with_gradient(jnp.asarray(x), -CLIP_VALUE, CLIP_VALUE)
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jax.grad(clipped_sum)(x)))
    np.testing.assert_array_equal(xt.grad.numpy(), w)
    assert (np.abs(x) > CLIP_VALUE).mean() > 0.1

    # the network's view of the critic, at full width
    vn_j, vn_t = _vnorms()
    obs = None
    for network in (dict(normalize_value=True, clip_value=CLIP_VALUE),
                    dict(normalize_value=True), dict(clip_value=CLIP_VALUE)):
        _, net_j, net_t, params, norm = _npz_nets("deepmimic_dppo_pfpn", **network)
        if obs is None:
            obs = (np.asarray(norm.mean) + np.asarray(norm.std)
                   * rng.standard_normal((256, 197))).astype(np.float32)
        ot = torch.tensor(obs)
        with torch.no_grad():
            got = {"raw_value": net_t.raw_value(ot),
                   "normalized_value": net_t.normalized_value(ot, vn_t),
                   "value": net_t.value(ot, vn_t), "value_without_vnorm": net_t.value(ot)}
        want = {"raw_value": net_j.raw_value(params, norm, obs),
                "normalized_value": net_j.normalized_value(params, norm, obs, vn_j),
                "value": net_j.value(params, norm, obs, vn_j),
                "value_without_vnorm": net_j.value(params, norm, obs)}
        for k in got:
            err = _rel_err(got[k].numpy(), want[k])
            print(f"\n{network} {k}: {err:.2e} of max(1, |value|)", end="")
            assert err <= REL_TOL, (network, k)
        if "clip_value" in network:
            assert float(got["value_without_vnorm"].abs().max()) <= CLIP_VALUE
    assert float(got["raw_value"].max()) * VNORM["scale"] + VNORM["offset"] > CLIP_VALUE


@pytest.mark.parametrize("setting", ["deepmimic_dppo_pfpn", "deepmimic_a3c_pfpn"])
def test_update_with_value_normalization_matches_jax(setting):
    T = 32
    network = dict(normalize_value=True, clip_value=CLIP_VALUE)
    cfg_j, net_j, net_t, params, norm = _npz_nets(setting, **network)
    B = cfg_j.workers
    w = cfg_j.worker
    pcfg = dict(num_envs=B, unroll_length=T, minibatch_size=T * B, lr_actor=w.lr_actor,
                lr_critic=w.lr_critic, norm_clip=w.norm_clip)
    algo_j = (A2C if cfg_j.algo == "a2c" else PPO)(None, net_j, PPOConfig(**pcfg))
    algo_t = (TA2C if cfg_j.algo == "a2c" else TPPO)(None, net_t, TPPOConfig(**pcfg))
    vn_j, vn_t = _vnorms()

    # a fixed trajectory whose values are the denormalized critic's
    rng = np.random.default_rng(71)
    obs = (np.asarray(norm.mean) + np.asarray(norm.std)
           * rng.standard_normal((T, B, 197))).astype(np.float32)
    mode = np.asarray(jax.jit(net_j.act_deterministic)(params, norm, jnp.asarray(obs)))
    action = (mode + 0.05 * rng.standard_normal(mode.shape)).astype(np.float32)
    lp = np.asarray(jax.jit(net_j.log_prob)(params, norm, jnp.asarray(obs), jnp.asarray(action)))
    value = np.asarray(jax.jit(net_j.value)(params, norm, jnp.asarray(obs), vn_j))
    term = rng.random((T, B)) < 0.03
    traj = {
        "obs": obs, "action": action,
        "log_prob": (lp + 0.3 * rng.standard_normal(lp.shape)).astype(np.float32),
        "value": (value + 0.5 * rng.standard_normal(value.shape)).astype(np.float32),
        "reward": (2.0 * rng.random((T, B))).astype(np.float32),
        "next_value": (value + 0.5 * rng.standard_normal(value.shape)).astype(np.float32),
        "terminated": term, "done": term | (rng.random((T, B)) < 0.03),
    }
    adv = j_gae(*(jnp.asarray(traj[k]) for k in ("reward", "value", "next_value",
                                                  "terminated", "done")), 0.95, 0.95)
    batch_j = {k: jnp.asarray(traj[k]).reshape((T * B,) + traj[k].shape[2:])
               for k in ("obs", "action", "log_prob", "value")}
    batch_j["advantage"] = adv.reshape(-1)
    targets = np.asarray(batch_j["value"] + batch_j["advantage"])
    beyond = float((np.abs((targets - VNORM["mean"]) / VNORM["std"]) > CLIP_VALUE).mean())
    print(f"\n{setting}: {beyond:.0%} of the normalized targets beyond the clip")
    assert 0.05 < beyond < 0.95

    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(algo_j._loss, has_aux=True))(
        params, norm, batch_j, vn_j)
    state_j = JPPOState(
        params=params, opt_state=algo_j.tx.init(params), norm=norm,
        head_stats=net_j.init_stats(), env_state=None, obs=None, key=jax.random.PRNGKey(0),
        global_step=jnp.zeros((), jnp.int32), total_samples=jnp.zeros((), jnp.int32),
        ep_return=jnp.zeros(B), last_ep_return=jnp.zeros(B), vnorm=vn_j)
    state_j, _ = jax.jit(algo_j.update)(state_j, {k: jnp.asarray(v) for k, v in traj.items()})

    loss_t, _ = algo_t._loss({k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()}, vn_t)
    loss_t.backward()
    print(f"{setting}: loss port {float(loss_t.detach()):.7g}, JAX {float(loss_j):.7g}")
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=LOSS_RTOL)
    named = dict(net_t.named_parameters())
    worst = 0.0
    for name, g in load_jax_params(_flatten(grads_j)).items():
        rel = float((named[name].grad - g).abs().max()) / float(g.abs().max())
        worst = max(worst, rel)
        assert float(g.abs().max()) > 0 and rel <= GRAD_TOL, name
    print(f"{setting}: gradients max abs err / max |grad| {worst:.2e}")

    step_grads = {}
    opt_step = algo_t.opt.step

    def capturing_step():
        step_grads.update({k: p.grad.detach().clone() for k, p in named.items()})
        opt_step()

    algo_t.opt.step = capturing_step
    state_t = PPOState(net=net_t, opt=algo_t.opt, head_stats=net_t.init_stats(),
                       env_state=None, obs=None, generator=torch.Generator().manual_seed(0),
                       vnorm=vn_t)
    state_t, metrics_t = algo_t.update(state_t, {k: torch.tensor(v) for k, v in traj.items()})
    own = {}
    for key, v in _flatten(params).items():
        (name, _), = load_jax_params({key: v}).items()
        g = step_grads[name].numpy()
        own[key[len("params/"):]] = jnp.asarray(g.T if key.endswith("/w") else g)
    updates, _ = jax.jit(algo_j.tx.update)(_unflatten(own), algo_j.tx.init(params), params)
    want = load_jax_params(_flatten(jax.tree.map(lambda p, u: p + u, params, updates)))
    err = max(float((named[k].detach() - v).abs().max()) for k, v in want.items())
    err_j = max(float((named[k].detach() - v).abs().max())
                for k, v in load_jax_params(_flatten(state_j.params)).items())
    print(f"{setting}: post-update parameters vs JAX's clip + Adam of the port's gradients "
          f"{err:.2e} (vs JAX's own update {err_j:.2e})")
    assert err <= OPT_TOL
    errs = {k: _rel_err(getattr(state_t.vnorm, k).numpy(), getattr(state_j.vnorm, k))
            for k in state_j.vnorm._fields}
    print(f"{setting}: value normalizer after the update {errs}; port {state_t.vnorm}")
    assert max(errs.values()) <= REL_TOL, errs
    assert float(state_t.vnorm.std) != VNORM["std"] and state_t.global_step == 1
    assert np.isfinite(float(metrics_t["value_loss"]))


def test_build_refusals_and_checkpoints_without_new_fields(tmp_path, monkeypatch):
    # build_algo refuses what JAX's refuses (a stub env: the refusal does
    # not depend on it); the LSTM only where both packages build a network
    # for it (the off-policy algorithms take no recurrent net in either)
    monkeypatch.setattr(j_build_mod, "build_env", lambda cfg: StubEnv())
    monkeypatch.setattr(t_build_mod, "build_env", lambda cfg, device=None: StubEnv())
    presets = {"ppo": "deepmimic_dppo_pfpn", "a2c": "deepmimic_a3c_pfpn",
               "vtrace": "deepmimic_impala_gauss", "sac": "deepmimic_sac_pfpn",
               "ddpg": "deepmimic_ddpg_gauss"}
    refused = []
    for algo, lstm, nv, cv in itertools.product(presets, (None, 16), (False, True),
                                                (None, CLIP_VALUE)):
        if lstm and algo in ("sac", "ddpg"):
            continue
        outcome = {}
        for pkg, (cfg, build_algo) in zip(("jax", "port"), zip(
                _cfgs(presets[algo], lstm=lstm, normalize_value=nv, clip_value=cv),
                (j_build_mod.build_algo, t_build_mod.build_algo))):
            try:
                build_algo(cfg)
                outcome[pkg] = "built"
            except ValueError as e:
                outcome[pkg] = f"refused: {e}"
        assert outcome["jax"] == outcome["port"], (algo, lstm, nv, cv, outcome)
        if outcome["port"] != "built":
            refused.append((algo, lstm, nv, cv))
    print(f"\nrefused by both: {refused}")
    assert refused == [(a, lstm, True, cv) for a, lstm in
                       [("ppo", 16), ("a2c", 16), ("vtrace", None), ("vtrace", 16),
                        ("sac", None), ("ddpg", None)] for cv in (None, CLIP_VALUE)]
    monkeypatch.undo()

    # a checkpoint written before PPOState had vnorm and carry restores, the
    # two keeping the template's values
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for tag, network in (("vnorm", dict(normalize_value=True)), ("lstm", dict(lstm=16))):
        _, cfg = _cfgs("deepmimic_dppo_pfpn", actor_shape=(32,), critic_shape=(32,), **network)
        cfg = dataclasses.replace(cfg, workers=2, worker=dataclasses.replace(
            cfg.worker, unroll_length=4, batch_size=4))
        algo = t_build_mod.build_algo(cfg, "cpu")
        state, _ = algo.train_round(algo.init_state(torch.Generator().manual_seed(3)))
        ckpt = CheckpointManager(str(tmp_path / tag))
        path = ckpt.save(state.global_step, state)
        old = torch.load(path, weights_only=True)
        assert {"vnorm", "carry"} <= set(old)
        torch.save({k: v for k, v in old.items() if k not in ("vnorm", "carry")}, path)
        fresh = t_build_mod.build_algo(cfg, "cpu")
        template = fresh.init_state(torch.Generator().manual_seed(4))
        restored = ckpt.restore_latest(template)
        assert restored.vnorm is template.vnorm and restored.carry is template.carry
        assert (restored.global_step, restored.total_samples) == (state.global_step, 8)
        for (k, v), v2 in zip(algo.net.state_dict().items(), fresh.net.state_dict().values()):
            assert torch.equal(v, v2), k
        torch.testing.assert_close(restored.obs, state.obs, rtol=0, atol=0)
        # and the current file restores both
        ckpt.save(state.global_step, state)
        again = ckpt.restore_latest(fresh.init_state(torch.Generator().manual_seed(4)))
        for field in ("vnorm", "carry"):
            want = getattr(state, field)
            if want is None:
                assert getattr(again, field) is None
            else:
                assert type(getattr(again, field)) is type(want)
                for a, b in zip(getattr(again, field), want):
                    assert torch.equal(a, b), field
        if tag == "vnorm":
            assert float(state.vnorm.std) != 1.0
        else:
            assert float(state.carry.h.abs().max()) > 0
